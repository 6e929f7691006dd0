"""The port's data parallelism on the CPU: ranks are processes joined over
gloo, as ``torchrun`` would start them (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, LOCAL_RANK).  Every launch has its own timeout, so that a
hang fails its test.

- The train step on N ranks, each on its share of every global batch,
  against one process stepped on the whole batches: the ranks end bitwise
  equal to each other (the gradients are averaged by one all-reduce whose
  result every rank receives); against the one process, the mean of the
  ranks' losses within 1e-5 relative in f32 (sums reassociate) and 1e-2 in
  bf16 (the ranks' bf16 weight gradients sum fewer samples each), and the
  parameters within the Adam tolerance of ROADMAP's "Not faults" (at most
  2 * lr per update apart; in f32 also at most 0.1 % of them more than
  1e-3 * lr), or, with SGD, within 1e-3 of the largest change (as
  ``test_torch_train.py``), which holds only if each rank's loss weighs
  its share of the batch as the global loss does.  With the STGAN term
  the discriminator's parameters are held the same way (its Adamax lr is
  the model's 1e-3), which holds only if its BN statistics are the global
  batch's and its gradients are averaged over the ranks.
- The train CLI on 2 ranks: equal step counts on shards of uneven length,
  checkpoints and the config snapshot from rank 0 alone, one valid_loss,
  and the two configuration errors.
- The loader's shards against the JAX loader's ``_shard_order``.
"""
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ebfi_tpu_torch.models import EVFIAutoEx, init_weights
from ebfi_tpu_torch.parallel import dist as pdist
from ebfi_tpu_torch.parallel import spatial as pspatial
from ebfi_tpu_torch.train import (TrainState, build_adversarial, build_optimizer, init_adv_state,
                                  make_train_step)
import torch_threads  # noqa: F401  (one intra-op thread per test process)

ROOT = os.path.join(os.path.dirname(__file__), "..")
LAUNCH_TIMEOUT_S = 120
MODEL = dict(frame_basech=8, event_basech=8, inter_ch=8, tb=4, step=2, channels=[4, 6, 8, 12])
PER_RANK, H, W = 2, 32, 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(nproc, argv, timeout=LAUNCH_TIMEOUT_S):
    """Run ``python argv`` as ``nproc`` ranks of one gloo group; returns
    [(returncode, stdout, stderr)] by rank.  Kills every rank at the
    timeout and fails."""
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": str(nproc), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
               "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}
        procs.append(subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"{nproc} ranks of {argv[:2]} did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


# ------------------------------------------------------------ the train step

STEP_WORKER = r"""
import json, sys
import numpy as np, torch
from ebfi_tpu_torch.models import EVFIAutoEx, init_weights
from ebfi_tpu_torch.parallel import broadcast_module_, local_shard_info, maybe_init_distributed
from ebfi_tpu_torch.train import (TrainState, build_adversarial, build_optimizer, init_adv_state,
                                  make_train_step)

spec = json.loads(sys.argv[1])
assert maybe_init_distributed()
rank, world = local_shard_info()
model = init_weights(EVFIAutoEx(**spec["model"]), 0)
broadcast_module_(model)
updater, _ = build_optimizer(model, spec["opt"], accumulate_steps=spec["accu"],
                             data_parallel=True)
step = make_train_step(compute_dtype=torch.bfloat16 if spec["bf16"] else None, world=world,
                       loss_cfg=spec["loss"])
state = TrainState(model, updater)
data = np.load(spec["batches"])
if spec["loss"]:
    sample = torch.zeros((1,) + data["frame_0"].shape[1:])
    state.adv_state = init_adv_state(build_adversarial(spec["loss"], world), 1,
                                     {"target": sample, "frame": sample})
    broadcast_module_(state.adv_state.disc)
losses = []
for i in range(spec["micro_steps"]):
    n = data["frame_%d" % i].shape[0] // world
    b = {k: torch.from_numpy(data["%s_%d" % (k, i)][rank * n:(rank + 1) * n])
         for k in ("frame", "event", "t", "target")}
    state, m = step(state, b)
    losses.append(float(m["train_loss"]))
disc = state.adv_state.disc.state_dict() if spec["loss"] else {}
np.savez(spec["out"] % rank, losses=np.array(losses),
         **{k: v.numpy() for k, v in model.state_dict().items()},
         **{"disc." + k: v.numpy() for k, v in disc.items()})
"""

STEP_CASES = {
    # name: (ranks, optimizer, accumulation, bf16[, trainer.loss])
    "f32_adam": (2, {"name": "Adam", "args": {"lr": 1e-3}}, 1, False),
    "f32_adam_accu2": (2, {"name": "Adam", "args": {"lr": 1e-3}}, 2, False),
    "bf16_adam": (2, {"name": "Adam", "args": {"lr": 1e-3}}, 1, True),
    "bf16_adam_accu2": (2, {"name": "Adam", "args": {"lr": 1e-3}}, 2, True),
    "f32_sgd": (2, {"name": "SGD", "args": {"lr": 1e-2}}, 1, False),
    "f32_adam_4ranks": (4, {"name": "Adam", "args": {"lr": 1e-3}}, 1, False),
    # the discriminator's BN statistics over the global batch, its
    # gradients averaged before each of its Adamax (lr 1e-3) updates
    "f32_adam_stgan": (2, {"name": "Adam", "args": {"lr": 1e-3}}, 1, False,
                       {"adversarial": {"enabled": True, "gan_type": "STGAN", "weight": 0.05}}),
}
UPDATES = 2


def _global_batches(path, n, micro_steps, seed=1):
    rng = np.random.default_rng(seed)
    arrays = {}
    for i in range(micro_steps):
        b = {"frame": rng.uniform(0, 1, (n, H, W, 3)), "event": rng.uniform(0, 3, (n, H, W, 8)),
             "t": rng.uniform(0, 1, (n, 1)), "target": rng.uniform(0, 1, (n, H, W, 3))}
        arrays.update({f"{k}_{i}": v.astype(np.float32) for k, v in b.items()})
    np.savez(path, **arrays)
    return arrays


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_ranks_step_as_one_process_on_the_global_batch(tmp_path, case):
    ranks, opt, accu, bf16, loss_cfg = (*STEP_CASES[case], None)[:5]
    micro = UPDATES * accu
    model_kw = {**MODEL, "fast_mod": bf16}  # bf16 as FastVariants trains: fused Modification
    batches = _global_batches(tmp_path / "batches.npz", ranks * PER_RANK, micro)
    spec = {"model": model_kw, "opt": opt, "accu": accu, "bf16": bf16, "micro_steps": micro,
            "loss": loss_cfg, "batches": str(tmp_path / "batches.npz"),
            "out": str(tmp_path / "rank%d.npz")}
    for rc, out, err in launch(ranks, ["-c", STEP_WORKER, json.dumps(spec)]):
        assert rc == 0, err[-3000:]
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(ranks)]

    # one process on the whole batches, from the same initial weights
    model = init_weights(EVFIAutoEx(**model_kw), 0)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    updater, _ = build_optimizer(model, opt, accumulate_steps=accu)
    step = make_train_step(compute_dtype=torch.bfloat16 if bf16 else None, loss_cfg=loss_cfg)
    state, losses = TrainState(model, updater), []
    if loss_cfg:
        sample = torch.zeros((1, H, W, 3))
        state.adv_state = init_adv_state(build_adversarial(loss_cfg), 1,
                                         {"target": sample, "frame": sample})
    for i in range(micro):
        b = {k: torch.from_numpy(batches[f"{k}_{i}"]) for k in ("frame", "event", "t", "target")}
        state, m = step(state, b)
        losses.append(float(m["train_loss"]))
    want = {k: v.numpy() for k, v in model.state_dict().items()}
    if loss_cfg:  # Adamax's first updates are about lr * sign(g) too, lr 1e-3 as the model's
        want.update({"disc." + k: v.numpy() for k, v in state.adv_state.disc.state_dict().items()})

    for r in range(1, ranks):  # bitwise equal replicas
        for k in want:
            np.testing.assert_array_equal(got[r][k], got[0][k], err_msg=f"rank {r} {k}")
    rank_mean = np.mean([g["losses"] for g in got], axis=0)
    np.testing.assert_allclose(rank_mean, losses, rtol=1e-2 if bf16 else 1e-5)
    lr = opt["args"]["lr"]
    if opt["name"] == "SGD":
        moved = max(float((torch.from_numpy(want[k]) - init[k]).abs().max()) for k in want)
        assert moved > 0
        for k in want:
            np.testing.assert_allclose(got[0][k], want[k], rtol=0, atol=1e-3 * moved, err_msg=k)
    else:
        diffs = np.concatenate([np.abs(got[0][k] - want[k]).ravel() for k in want])
        assert diffs.max() <= 2 * lr * UPDATES
        if not bf16:
            assert (diffs > 1e-3 * lr).mean() <= 1e-3


def test_buckets_keep_order_and_cap_bytes():
    ts = [torch.zeros(10), torch.zeros(300), torch.zeros(5, dtype=torch.float64), torch.zeros(3),
          torch.zeros(4)]
    got = [[id(t) for t in b] for b in pdist._buckets(ts, cap=1000)]
    assert got == [[id(ts[0])], [id(ts[1])], [id(ts[2])], [id(ts[3]), id(ts[4])]]
    assert sum(len(b) for b in got) == len(ts)


def test_without_a_group_everything_is_one_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not pdist.maybe_init_distributed()
    assert pdist.local_shard_info() == (0, 1) and pdist.is_primary()
    t = torch.arange(4.0)
    pdist.all_reduce_mean_([t])
    pdist.barrier()
    assert torch.equal(t, torch.arange(4.0))
    # spatial parallelism without a group: the grid of one process, one band
    spec = pspatial.spatial_shardings(1)
    assert (spec.data, spec.model, spec.model_group) == (1, 1, None)
    with pytest.raises(ValueError, match="needs a process group"):
        pspatial.spatial_shardings(2)
    # with one: its model and data groups (1 x 1 here; the 1 x 2 and 2 x 2
    # grids in test_torch_spatial.py)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                                         rank=0, world_size=1)
    try:
        spec = pspatial.spatial_shardings(1)
        assert spec.backend == "gloo" and (spec.data_index, spec.band_index) == (0, 0)
        for group in (spec.model_group, spec.data_group):
            assert torch.distributed.get_process_group_ranks(group) == [0]
        with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
            pspatial.spatial_shardings(2)
    finally:
        torch.distributed.destroy_process_group()


def test_local_device_follows_the_launcher(monkeypatch):
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pdist.local_device("cuda") == torch.device("cuda", 1)
    assert pdist.local_device("cuda:0") == torch.device("cuda", 0)
    assert pdist.local_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("RANK")
    assert pdist.local_device("cuda") == torch.device("cuda", 0)


# ------------------------------------------------------------- the train CLI

CLI_WORKER = r"""
import json, sys
from ebfi_tpu_torch.train.cli import main

argv = sys.argv[1:]
rank = int(__import__("os").environ["RANK"])
argv[argv.index("-c") + 1] = argv[argv.index("-c") + 1] % rank  # one config per rank
t = main(argv)
valid = t._valid()  # every rank: the validation is a collective
print("RESULT " + json.dumps({"step": t.state.step, "best": t.mnt_best, "valid": valid,
                              "batches": len(t.train_loader)}))
"""


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from ebfi_tpu_torch.data.synth import write_clip_npz

    d = tmp_path_factory.mktemp("dist_clip")
    path = str(d / "clip.npz")
    write_clip_npz(path, num_frames=25, H=32, W=32, seed=2)  # 3 windows of one period of 8
    (d / "train.txt").write_text(path + "\n")
    return d


def _cli_cfg(clip, out, **extra):
    from test_torch_train_cli import _full_cfg

    return _full_cfg(clip, out, **{
        "trainer;iteration_based_train;enabled": False,
        "trainer;epoch_based_train;enabled": True,
        "trainer;epoch_based_train;epochs": 2,
        "trainer;epoch_based_train;train_log_step": 1,
        "trainer;monitor": "min valid_loss",
        **extra,
    })


def _write(path, cfg):
    from ebfi_tpu_torch.utils.logger import dump_yaml

    path.write_text(dump_yaml(cfg))
    return str(path)


def test_train_cli_on_two_ranks(clip, tmp_path):
    """3 windows over 2 ranks: shard 0 holds two, shard 1 one; each rank
    loads 1 window of every global batch of 2 (no drop_last), so an
    uneven shard would take one more batch of steps and hang its
    collectives.  Each rank writes its own config whose only difference is
    the output path, so that what each rank wrote can be told apart."""
    for rank in range(2):
        _write(tmp_path / f"cfg{rank}.yml",
               _cli_cfg(clip, tmp_path / f"out{rank}", **{"train_dataloader;drop_last": False}))
    runs = launch(2, ["-c", CLI_WORKER, "-c", str(tmp_path / "cfg%d.yml"), "-id", "dp",
                      "--device", "cpu"])
    results, logged = [], []
    for rc, out, err in runs:
        assert rc == 0, err[-3000:]
        results.append(json.loads(out.split("RESULT ", 1)[1]))
        logged.append(re.findall(r"Iteration: (\d+)/\d+ train_loss: (\S+)", out))
    # one batch of 8 timestamps per epoch on each rank; the same global
    # losses logged at every step, the same validation
    assert results[0] == results[1] and results[0]["step"] == 2 * 8
    assert results[0]["batches"] == 1 and results[0]["valid"]["valid_loss"] > 0
    assert len(logged[0]) == 2 * 8 and logged[0] == logged[1]
    names = sorted(os.listdir(tmp_path / "out0" / "models" / "EVFIAutoEx" / "dp"))
    assert names == ["checkpoint-epoch1.pt", "checkpoint-epoch2.pt"]
    assert os.listdir(tmp_path / "out1" / "models" / "EVFIAutoEx" / "dp") == []
    logs = [tmp_path / f"out{r}" / "logs" / "EVFIAutoEx" / "dp" for r in range(2)]
    assert (logs[0] / "config.yml").exists() and os.listdir(logs[1]) == []


@pytest.mark.parametrize("case", ["batch_not_divisible", "data_parallel_mismatch", "empty_shard"])
def test_train_cli_configuration_errors(clip, tmp_path, case):
    extra, message = {
        "batch_not_divisible": ({"train_dataloader;batch_size": 3},
                                "batch_size (3) must be divisible by the number of "
                                "data-loading processes (2)"),
        "data_parallel_mismatch": ({"parallel": {"data_parallel": 4}},
                                   "parallel.data_parallel is 4, but 2 process(es) were launched"),
        # 3 windows: one per rank, short of a batch of 2 per rank under drop_last
        "empty_shard": ({"train_dataloader;batch_size": 4, "train_dataloader;drop_last": True},
                        "the training data holds no batch for rank"),
    }[case]
    cfg = _cli_cfg(clip, tmp_path / "out")
    if "parallel" in extra:
        cfg["parallel"] = extra.pop("parallel")
    for path, value in extra.items():
        section, key = path.split(";")
        cfg[section][key] = value
    for rank in range(2):
        _write(tmp_path / f"cfg{rank}.yml", cfg)
    for rc, out, err in launch(2, ["-c", CLI_WORKER, "-c", str(tmp_path / "cfg%d.yml"), "-id",
                                   "bad", "--device", "cpu"]):
        assert rc != 0 and message in err, err[-2000:]


# ------------------------------------------------------------------ the loader


@pytest.fixture(scope="module")
def h5_and_npz(tmp_path_factory):
    from ebfi_tpu.data.synth import write_clip_h5

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from h5_to_npz import h5_to_npz

    d = tmp_path_factory.mktemp("dist_loader")
    h5 = str(d / "clip.h5")
    write_clip_h5(h5, num_frames=25, H=32, W=32, seed=3)
    return h5, h5_to_npz(h5, str(d / "npz"))


@pytest.mark.parametrize("shards", [(0, 2), (1, 2), (2, 3), (0, 4), (3, 4)])
def test_loader_shards_follow_the_jax_order(h5_and_npz, shards):
    from ebfi_tpu.data.dataloader import EBFIDataLoader as JaxLoader
    from ebfi_tpu_torch.data.dataloader import EBFIDataLoader
    from test_data import dataset_cfg

    h5, npz = h5_and_npz
    shard, n = shards
    dcfg = dataset_cfg(time_bins=4, NumPeriodPerSeq=1, SlidingWindowSeq=1)
    kw = dict(batch_size=1, shuffle=True, seed=7)
    jax = JaxLoader([h5] * 5, dcfg, shard_index=shard, num_shards=n, **kw)
    total = len(jax.index)  # 15 windows: shards of uneven length for n = 2 and 4
    for epoch in (0, 1):
        jax.set_epoch(epoch)
        ports = [EBFIDataLoader([npz] * 5, dcfg, shard_index=s, num_shards=n, **kw)
                 for s in range(n)]
        for p in ports:
            p.set_epoch(epoch)
        want = jax._shard_order()
        got = ports[shard]._shard_order()
        assert got == want[: total // n] and len(want) - len(got) <= 1
        orders = [p._shard_order() for p in ports]
        assert len({len(o) for o in orders}) == 1 and len({len(p) for p in ports}) == 1
        assert len(set(sum(orders, []))) == n * (total // n)
