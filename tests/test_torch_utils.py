"""The port's utility API, flow visualization, event visualizers and legacy
event helpers against the JAX package's, on the CPU.

numpy results are compared exactly; ``normalize_event_tensor`` (a float
reduction in either framework) at rtol 1e-6; PNG trees by their decoded
pixels.
"""
import time

import jax
import jax.numpy as jnp
import matplotlib.colors
import numpy as np
import pytest
import torch

from ebfi_tpu.data import legacy_util as jlegacy
from ebfi_tpu.utils import flow_vis as jflow
from ebfi_tpu.utils import vis as jvis
from ebfi_tpu import utils as jutils
from ebfi_tpu_torch import utils as tutils
from ebfi_tpu_torch.data import legacy_util as tlegacy
from ebfi_tpu_torch.utils import flow_vis as tflow
from ebfi_tpu_torch.utils.profiling import trace
from ebfi_tpu_torch.utils.timers import _timers
from ebfi_tpu_torch.utils import vis as tvis
from ebfi_tpu_torch.utils.vis import read_png
import torch_threads  # noqa: F401  (one intra-op thread per test process)


def test_the_utility_api_exports_what_jax_exports():
    assert tutils.__all__ == jutils.__all__


def test_timers_report_like_jax():
    for name, timer in (("t_host", tutils.Timer("t_host")),
                        ("t_device", tutils.DeviceTimer("t_device", device="cpu"))):
        _timers.pop(name, None)
        for _ in range(2):
            with timer:
                time.sleep(0.002)
        rep = tutils.timing_report()[name]
        assert set(rep) == {"mean_s", "total_s", "count"} and rep["count"] == 2
        assert 0.002 <= rep["mean_s"] and abs(rep["total_s"] - 2 * rep["mean_s"]) < 1e-12
        _timers.pop(name)


def test_normalize_event_tensor_matches_jax(rng):
    x = np.zeros((2, 9, 11), np.float32)
    x[:, 2:6, 3:8] = rng.standard_normal((2, 4, 5)).astype(np.float32) * 4 + 3
    got = tutils.normalize_event_tensor(torch.from_numpy(x)).numpy()
    want = np.asarray(jutils.normalize_event_tensor(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[x == 0] == 0).all()


def test_misc_helpers_match_jax(rng):
    img = rng.uniform(-0.5, 1.5, (4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tutils.to_uint8_image(torch.from_numpy(img)),
                                  jutils.to_uint8_image(img))
    it = tutils.inf_loop([1, 2])
    assert [next(it) for _ in range(5)] == [1, 2, 1, 2, 1]
    from ebfi_tpu.models import EVFIAutoEx as JaxEVFI
    from ebfi_tpu_torch.models import EVFIAutoEx

    args = dict(frame_basech=8, event_basech=8, inter_ch=8, tb=2, step=2,
                channels=(4, 6, 8, 12))
    z = [jnp.zeros(s) for s in ((1, 16, 16, 3), (1, 16, 16, 4), (1, 1))]
    jparams = jax.eval_shape(lambda: JaxEVFI(**args).init(jax.random.key(0), *z))
    model = EVFIAutoEx(**args)
    assert tutils.param_count(model) == jutils.param_count(jparams) > 0
    assert tutils.param_count(model.state_dict()) == jutils.param_count(jparams)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    files = list((tmp_path / "trace").glob("trace-*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0


def test_hsv_to_rgb_matches_matplotlib(rng):
    hsv = rng.uniform(0, 1, (40, 3))
    hsv[:5, 0] = [0.0, 1 / 6, 0.5, 1.0, 5 / 6]  # sector edges, a hue of 1
    hsv[5:8, 1] = 0.0  # grey
    np.testing.assert_array_equal(tflow.hsv_to_rgb(hsv), matplotlib.colors.hsv_to_rgb(hsv))
    with pytest.raises(ValueError):
        tflow.hsv_to_rgb(np.full((1, 3), 1.5))


def test_flow_visualization_matches_jax(tmp_path, rng):
    H, W = 20, 28
    flow = rng.standard_normal((H, W, 2)).astype(np.float32)
    np.testing.assert_array_equal(tflow.flow_to_image(flow[..., 0], flow[..., 1]),
                                  jflow.flow_to_image(flow[..., 0], flow[..., 1]))
    np.testing.assert_array_equal(tflow.minmax_norm(flow), jflow.minmax_norm(flow))
    inputs = [dict(event_cnt=np.abs(rng.standard_normal((H, W, 2))).astype(np.float32),
                   flow=rng.standard_normal((H, W, 2)).astype(np.float32),
                   iwe=np.abs(rng.standard_normal((H, W, 2))).astype(np.float32),
                   brightness=rng.uniform(0, 1, (H, W)).astype(np.float32), sequence="seq0",
                   frames=rng.uniform(0, 255, (H, W, 3)).astype(np.uint8), ts=ts)
              for ts in (0.0, 0.1)]
    for mod, name in ((tflow, "port"), (jflow, "jax")):
        viz = mod.FlowVisualization(str(tmp_path / name))
        for kw in inputs:
            viz.store(**kw)
        viz.close()
    port, ref = tmp_path / "port" / "seq0", tmp_path / "jax" / "seq0"
    for sub in ("events", "flow", "frames", "iwe", "brightness"):
        names = sorted(p.name for p in (ref / sub).glob("*.png"))
        assert names == sorted(p.name for p in (port / sub).glob("*.png")) and len(names) == 2
        for n in names:
            np.testing.assert_array_equal(read_png(str(port / sub / n)),
                                          read_png(str(ref / sub / n)), err_msg=f"{sub}/{n}")
    assert (port / "timestamps.txt").read_text() == (ref / "timestamps.txt").read_text()


@pytest.mark.parametrize("tb", [16, 6, 5])
def test_event_stack_visualizers_match_jax(tmp_path, rng, monkeypatch, tb):
    """``stack_to_cnt`` exactly, and ``save_event_stack_grid``'s PNG against
    the canvas the JAX writer hands its ``save_frame`` (captured, not
    written): 16 bins tile 4 x 4, 6 tile 2 x 3, 5 tile 1 x 5."""
    H, W = 9, 13
    stack = np.abs(rng.standard_normal((H, W, 2 * tb)) * 8).astype(np.float32)
    stack[:3] = 0.0
    np.testing.assert_array_equal(tvis.stack_to_cnt(stack), jvis.stack_to_cnt(stack))
    captured = []
    monkeypatch.setattr(jvis, "save_frame", lambda frame, path: captured.append(frame))
    jvis.save_event_stack_grid(stack, str(tmp_path / "jax.png"), vmax=6.0)
    tvis.save_event_stack_grid(stack, str(tmp_path / "port.png"), vmax=6.0)
    (want,) = captured
    got = read_png(str(tmp_path / "port.png"))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 2


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_legacy_event_helpers_match_jax(rng, noise):
    n = 300
    xs, ys = rng.integers(-2, 18, n), rng.integers(-2, 14, n)
    ts, ps = np.sort(rng.uniform(0, 1, n)), rng.choice([-1.0, 1.0], n)
    got = tlegacy.event2frame(xs, ys, ts, ps, (12, 16), 0.5, noise, np.random.default_rng(3))
    want = jlegacy.event2frame(xs, ys, ts, ps, (12, 16), 0.5, noise, np.random.default_rng(3))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tlegacy.filter_events(xs, ys, ts, ps, 0.2, 0.8),
                    jlegacy.filter_events(xs, ys, ts, ps, 0.2, 0.8)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tlegacy.filter_events_by_space(xs, ys, ts, ps, 5, 15, 3, 11),
                    jlegacy.filter_events_by_space(xs, ys, ts, ps, 5, 15, 3, 11)):
        np.testing.assert_array_equal(a, b)
