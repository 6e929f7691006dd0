"""Imported by every ``test_torch_*.py``: one PyTorch intra-op thread per
test process.  The tier-1 run spreads the files over several pytest-xdist
workers on one machine, and PyTorch's default of one OpenMP thread per
core in every worker oversubscribes the cores many times over: alone,
``test_torch_train_cli.py::test_epoch_based_training`` takes 18 s with 8
threads and 10 s with one, and among six workers it took 200-360 s.  The
tests' tiny shapes gain nothing from more threads.  (The ranks the
distributed tests launch set ``OMP_NUM_THREADS`` themselves.)"""
import torch

torch.set_num_threads(1)
