import torch.distributed as dist

from .cli import main

if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
