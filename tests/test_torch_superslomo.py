"""The port's SuperSloMo (``ebfi_tpu_torch/models/superslomo.py``) against
``ebfi_tpu.models.superslomo`` on the CPU, with the JAX package's random
weights (``init_params``) mapped by ``superslomo_params_from_jax``.

Tolerances:
- the UNets, f32: 1e-4 relative to the output's largest magnitude (ten
  levels of 3x3-7x7 convolutions up to 512 channels deep, sums in another
  order);
- ``back_warp``: 1e-6 absolute on values in [0, 1] (the same four-corner
  gather and weights, in the same order);
- ``_interp_fn`` and the upsampled frames: 1e-4 absolute on values in
  [0, 1] (two UNets and four warps, whose sample positions move with the
  flows' last digits).
- ``upsample_sequence``'s insertion counts ``ceil(max |F|)`` must agree
  wherever the JAX maximum lies more than 1e-4 (relative) from an integer;
  nearer, float noise may put the two frameworks on either side (ROADMAP
  "Not faults"), and the test then asserts only the pair's frames and
  times that both made.
"""
import datetime
import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebfi_tpu.models import superslomo as jss
from ebfi_tpu_torch.models import superslomo_params_from_jax
from ebfi_tpu_torch.models import superslomo as tss
import torch_threads  # noqa: F401  (one intra-op thread per test process)

FLOW_BIAS = np.array([3.5, -2.5, 1.5, -3.0], np.float32)  # |flow| ~ 3-4: 2-4 insertions


def _params(seed=0, flow_bias=True):
    p = jax.tree.map(np.asarray, jss.init_params(seed, 32, 32))
    if flow_bias:  # untrained nets predict sub-pixel flow: nothing would be inserted
        p["flow"]["conv3"]["bias"] = p["flow"]["conv3"]["bias"] + FLOW_BIAS
    return p


def _port(params):
    fsd, isd = superslomo_params_from_jax(params)
    flow, interp = tss.SloMoUNet(6, 4), tss.SloMoUNet(20, 5)
    flow.load_state_dict(fsd, strict=True)
    interp.load_state_dict(isd, strict=True)
    return tss.SuperSloMo(flow, interp)


@pytest.fixture(scope="module")
def nets():
    p = _params()
    return p, jss.SuperSloMo(p), _port(p)


def _close(got, want, atol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


def test_unet_names_are_the_reference_checkpoints():
    names = set(tss.SloMoUNet(6, 4).state_dict())
    want = {f"{m}.{p}" for m in ["conv1", "conv2", "conv3"]
            + [f"{d}{i}.conv{j}" for d in ("down", "up") for i in range(1, 6) for j in (1, 2)]
            for p in ("weight", "bias")}
    assert names == want


@pytest.mark.parametrize("which", ["flow", "interp"])
def test_unet_matches_jax(nets, which):
    p, _, port = nets
    cin, cout = (6, 4) if which == "flow" else (20, 5)
    x = np.random.default_rng(1).standard_normal((2, 64, 96, cin)).astype(np.float32)
    want = np.asarray(jss.SloMoUNet(cout).apply({"params": p[which]}, jnp.asarray(x)))
    net = port.flow_net if which == "flow" else port.interp_net
    with torch.no_grad():
        got = tss.unet_nhwc(net, torch.from_numpy(x))
    _close(got, want, 1e-4 * np.abs(want).max())


def test_back_warp_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    flow = (3.0 * rng.standard_normal((2, 24, 32, 2))).astype(np.float32)
    want = jss.back_warp(jnp.asarray(img), jnp.asarray(flow))
    _close(tss.back_warp(torch.from_numpy(img), torch.from_numpy(flow)), want, 1e-6)


@pytest.mark.parametrize("t", [0.25, 1.0 / 3.0])
def test_interp_fn_matches_jax(nets, t):
    p, jax_slomo, port = nets
    rng = np.random.default_rng(3)
    i0, i1 = (rng.uniform(-0.4, 0.6, (1, 32, 64, 3)).astype(np.float32) for _ in range(2))
    f01, f10 = ((2.0 * rng.standard_normal((1, 32, 64, 2))).astype(np.float32) for _ in range(2))
    want = jax_slomo._interp_fn(jax_slomo.params, *(jnp.asarray(a) for a in (i0, i1, f01, f10)), t)
    got = port._interp_fn(*(torch.from_numpy(a) for a in (i0, i1, f01, f10)), t)
    _close(got, want, 1e-4)


def test_flow_and_insert_count_match_jax(nets):
    _, jax_slomo, port = nets
    rng = np.random.default_rng(4)
    i0, i1 = (rng.uniform(-0.4, 0.6, (1, 32, 64, 3)).astype(np.float32) for _ in range(2))
    jf = jax_slomo.flow(jnp.asarray(i0), jnp.asarray(i1))
    tf = port.flow(torch.from_numpy(i0), torch.from_numpy(i1))
    for a, b in zip(tf, jf):
        _close(a, b, 1e-4 * float(np.abs(np.asarray(b)).max()))
    m = max(float(jnp.sqrt((f ** 2).sum(-1)).max()) for f in jf)
    assert port.insert_count(*tf) == jax_slomo.insert_count(*jf) == math.ceil(m) >= 3


def _count_is_decidable(jax_slomo, i0, i1):
    f01, f10 = jax_slomo.flow(i0, i1)
    m = max(float(jnp.sqrt((f ** 2).sum(-1)).max()) for f in (f01, f10))
    return abs(m - round(m)) > 1e-4 * m


def test_upsample_sequence_matches_jax(nets):
    """Three frames at 40x56 (edge-padded to 64x64 for the UNets): the
    frames, times and counts of both pairs; the sequence's last frame is
    never emitted."""
    p, jax_slomo, port = nets
    rng = np.random.default_rng(5)
    base = rng.uniform(0, 1, (40, 60, 3)).astype(np.float32)
    frames = np.stack([base[:, s:s + 56] for s in (0, 2, 4)])
    ts = np.arange(3) / 240.0
    want, want_ts = jax_slomo.upsample_sequence(frames, ts)
    got, got_ts = port.upsample_sequence(frames, ts)
    mean = np.asarray(jss.MEAN, np.float32)
    pad = lambda f: jnp.asarray(np.pad(f, ((0, 24), (0, 8), (0, 0)), mode="edge")[None] - mean)
    decidable = all(_count_is_decidable(jax_slomo, pad(frames[i]), pad(frames[i + 1]))
                    for i in range(2))
    if decidable:
        assert len(got_ts) == len(want_ts) and got.shape == want.shape
        np.testing.assert_array_equal(np.asarray(got_ts), np.asarray(want_ts))
        _close(got, want, 1e-4)
    else:  # compare the frames both made, pair by pair (by their times)
        common = sorted(set(got_ts) & set(want_ts))
        assert len(common) >= 2
        for t in common:
            _close(got[got_ts.index(t)], want[want_ts.index(t)], 1e-4)
    assert got.dtype == np.float32 and len(got_ts) > 2  # frames were inserted
    np.testing.assert_array_equal(got[0], frames[0])
    assert got_ts[-1] < ts[-1]


def test_checkpoint_round_trip_with_the_jax_converter(tmp_path):
    """A checkpoint written in the published layout loads strictly into the
    port and, through ``convert_torch_checkpoint``, into the JAX package:
    the same weights on both sides."""
    p = _params(7, flow_bias=False)
    fsd, isd = superslomo_params_from_jax(p)
    path = str(tmp_path / "SuperSloMo.ckpt")
    tss.save_checkpoint(path, fsd, isd)
    port = tss.load_checkpoint(path)
    back = jss.convert_torch_checkpoint(path)
    for which, net in (("flow", port.flow_net), ("interp", port.interp_net)):
        jl, tree = jax.tree.flatten(back[which])
        wl = jax.tree.leaves(p[which])
        assert all(np.array_equal(a, b) for a, b in zip(jl, wl))
        sd = net.state_dict()
        assert all(torch.equal(sd[k], v) for k, v in (fsd if which == "flow" else isd).items())


class _Arbitrary:
    """A class no checkpoint loader should instantiate."""


def _upstream_checkpoint(fsd, isd, **extra):
    """A checkpoint as the upstream Super-SloMo training script saves it:
    metadata beside the two state dicts."""
    return {
        "Detail": "End to end Super SloMo.", "epoch": 199,
        "timestamp": datetime.datetime(2018, 9, 14, 11, 5, 42, 123456),
        "trainBatchSz": 6, "validationBatchSz": 10, "learningRate": 1e-05,
        "loss": [[0.31, 0.27], [0.22]], "valLoss": [0.25, 0.21], "valPSNR": [29.4, 30.1],
        "state_dictFC": fsd, "state_dictAT": isd, **extra,
    }


@pytest.mark.parametrize("payload", ["upstream_metadata", "arbitrary_class"])
def test_checkpoint_with_training_metadata_loads_and_other_classes_do_not(tmp_path, payload):
    """C4: ``load_checkpoint`` keeps ``weights_only=True``; the training
    script's metadata (a datetime among strings, ints, floats and lists of
    floats) loads into the same UNets, and a pickled class of any other
    kind is still refused."""
    fsd, isd = superslomo_params_from_jax(_params(5, flow_bias=False))
    path = str(tmp_path / "SuperSloMo.ckpt")
    extra = {"extra": _Arbitrary()} if payload == "arbitrary_class" else {}
    torch.save(_upstream_checkpoint(fsd, isd, **extra), path)
    if payload == "arbitrary_class":
        with pytest.raises(pickle.UnpicklingError, match="_Arbitrary"):
            tss.load_checkpoint(path)
        return
    port = tss.load_checkpoint(path)
    for sd, net in ((fsd, port.flow_net), (isd, port.interp_net)):
        got = net.state_dict()
        assert sorted(got) == sorted(sd)
        assert all(torch.equal(got[k], v) for k, v in sd.items())


def test_init_unet_draws_from_the_generator():
    a = tss.init_unet_(tss.SloMoUNet(6, 4), torch.Generator().manual_seed(3))
    b = tss.init_unet_(tss.SloMoUNet(6, 4), torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    w = a.down1.conv1.weight.detach()
    assert float(w.abs().max()) <= 1 / math.sqrt(w[0].numel())
