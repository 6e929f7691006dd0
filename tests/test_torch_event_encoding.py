"""The port's device event encoders (``ebfi_tpu_torch.ops.event_encoding``)
against ``ebfi_tpu.ops.event_encoding`` on the CPU, bit for bit: the
weights are unit polarities, so every sum is exact in any order, and the
bin edges follow the JAX op order in f32.  The cases are those of
``test_ops_event_encoding.py``: random streams, events exactly on the f32
bin edges, padding with ``n_valid``, out-of-range pixels, the degenerate
stream; plus the channel, mask, polarity, hot-pixel and voxel encoders."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebfi_tpu.ops import event_encoding as jenc
from ebfi_tpu_torch.ops import event_encoding as tenc
import torch_threads  # noqa: F401  (one intra-op thread per test process)


def make_events(rng, n=500, H=12, W=16):
    xs = rng.integers(0, W, n).astype(np.float32)
    ys = rng.integers(0, H, n).astype(np.float32)
    ts = np.sort(rng.uniform(0.0, 1.0, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return xs, ys, ts, ps


def _both(name, arrays, *args, **kw):
    want = np.asarray(getattr(jenc, name)(*[jnp.asarray(a) for a in arrays], *args, **{
        k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}))
    got = getattr(tenc, name)(*[torch.from_numpy(a) for a in arrays], *args, **{
        k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    return got.numpy(), want


@pytest.mark.parametrize("tb,hw", [(16, (12, 16)), (5, (7, 9)), (1, (4, 4))])
def test_stack_matches_jax(tb, hw):
    rng = np.random.default_rng(tb)
    got, want = _both("events_to_stack", make_events(rng, 800, *hw), tb, hw)
    assert got.dtype == np.float32 and got.shape == (2, tb, *hw)
    np.testing.assert_array_equal(got, want)


def _edge_stream(TB=4, H=8, W=8, seed=0):
    """Events exactly on every interior bin edge, the edges computed in f32
    in the JAX op order, plus interior fillers."""
    t0, t_last = np.float32(0.25), np.float32(1.75)
    delta = (t_last - t0 + np.float32(1e-6)) / np.float32(TB)
    edges = [t0 + delta * np.float32(b) for b in range(1, TB)]
    ts = np.sort(np.array([t0, *edges, 0.5, 1.0, 1.5, *edges, t_last], np.float32))
    rng = np.random.default_rng(seed)
    n = len(ts)
    xs = rng.integers(0, W, n).astype(np.float32)
    ys = rng.integers(0, H, n).astype(np.float32)
    ps = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0).astype(np.float32)
    return (xs, ys, ts, ps), TB, (H, W)


def test_stack_events_on_bin_edges_land_in_both_bins():
    arrays, tb, hw = _edge_stream()
    got, want = _both("events_to_stack", arrays, tb, hw)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > len(arrays[0])  # edge events counted twice


def test_stack_padded_matches_unpadded():
    rng = np.random.default_rng(3)
    xs, ys, ts, ps = make_events(rng, 300)
    ref = tenc.events_to_stack(*map(torch.from_numpy, (xs, ys, ts, ps)), 8, (12, 16))
    pad = 212
    padded = (np.concatenate([xs, np.zeros(pad, np.float32)]),
              np.concatenate([ys, np.zeros(pad, np.float32)]),
              np.concatenate([ts, np.full(pad, 2.0, np.float32)]),
              np.concatenate([ps, np.ones(pad, np.float32)]))
    for n_valid in (300, np.asarray(300, np.int32)):
        got, want = _both("events_to_stack", padded, 8, (12, 16), n_valid=n_valid)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref.numpy())


@pytest.mark.parametrize("case", ["all_zero_ts", "three_events", "padded_to_three"])
def test_stack_degenerate_stream_is_zero(case):
    rng = np.random.default_rng(4)
    xs, ys, ts, ps = make_events(rng, 10, 4, 4)
    kw = {}
    if case == "all_zero_ts":
        ts = np.zeros_like(ts)
    elif case == "three_events":
        xs, ys, ts, ps = xs[:3], ys[:3], ts[:3], ps[:3]
    else:
        kw["n_valid"] = 3
    got, want = _both("events_to_stack", (xs, ys, ts, ps), 4, (4, 4), **kw)
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_stack_out_of_range_pixels_are_dropped():
    arrays = (np.array([0, 5, 100, -1, 3], np.float32), np.array([0, 3, 2, 2, -7], np.float32),
              np.array([0.0, 0.3, 0.6, 0.8, 1.0], np.float32),
              np.array([1, -1, 1, 1, -1], np.float32))
    got, want = _both("events_to_stack", arrays, 2, (4, 8))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 2.0 and got[0, 0, 0, 0] == 1.0 and got[1, 0, 3, 5] == 1.0


def test_channels_match_jax():
    rng = np.random.default_rng(5)
    xs, ys, ts, ps = make_events(rng, 400)
    xs[:7] = 40  # out of range
    for kw in ({}, {"n_valid": 250}):
        got, want = _both("events_to_channels", (xs, ys, ps), (12, 16), **kw)
        np.testing.assert_array_equal(got, want)


def test_mask_keeps_the_last_event():
    rng = np.random.default_rng(6)
    xs, ys, _, _ = make_events(rng, 300, 6, 5)  # many events per pixel
    ps = rng.uniform(-2, 2, 300).astype(np.float32)  # the last write decides
    xs[:5] = -3
    got, want = _both("events_to_mask", (xs, ys, ps), (6, 5))
    np.testing.assert_array_equal(got, want)


def test_polarity_mask_and_hot_pixels_match_jax():
    ps = np.array([1.0, -1.0, 0.0, 2.5, -0.5], np.float32)
    got, want = _both("events_polarity_mask", (ps,))
    np.testing.assert_array_equal(got, want)
    rate = np.random.default_rng(7).permutation(np.linspace(0.0, 1.0, 48, dtype=np.float32))
    rate = rate.reshape(6, 8)
    for idx, max_px in ((3, 10), (9, 10), (9, 100)):
        got, want = _both("get_hot_event_mask", (rate,), idx, max_px=max_px)
        np.testing.assert_array_equal(got, want)
    assert (got == 0).sum() == (rate > 0.8).sum()


def test_voxel_matches_jax():
    rng = np.random.default_rng(8)
    xs, ys, ts, ps = make_events(rng, 200, 6, 7)
    xs[:3] = 9
    for kw in ({}, {"n_valid": 150}):
        got, want = _both("events_to_voxel", (xs, ys, ts, ps), 5, (6, 7), **kw)
        np.testing.assert_array_equal(got, want)
