"""Every kernel launch, and every weight pack before one, runs with the
input's device current: the C entry points launch on the CUDA runtime's
current device, the stream they get belongs to the input's.

There is no card here, so the launch is stubbed: the library, the
argument checks and the stream are replaced, ``torch.cuda.device`` by a
recorder, and ``_launch*`` is called with CPU tensors, as the wrappers
call it with CUDA ones.  The recorder notes the device each guard was
entered with, and the stubbed library and weight pack note whether they
ran inside a guard.  The plain-recompute backward enters no guard.
"""
import contextlib

import numpy as np
import pytest
import torch

from ebfi_tpu_torch.ops.cuda import fac as fac_mod
from ebfi_tpu_torch.ops.cuda import mod_fac as mod_fac_mod
import torch_threads  # noqa: F401  (one intra-op thread per test process)

K, C = 5, 64


class Recorder:
    def __init__(self):
        self.entered, self.depth, self.calls = [], 0, []

    def device(self, device):
        @contextlib.contextmanager
        def guard():
            self.entered.append(torch.device(device))
            self.depth += 1
            try:
                yield
            finally:
                self.depth -= 1
        return guard()

    def note(self, name):
        self.calls.append((name, self.depth > 0))


class FakeLib:
    def __init__(self, rec):
        self.rec = rec

    def __getattr__(self, name):
        def entry(*args):
            self.rec.note(name)
            return 0
        return entry


@pytest.fixture
def rec(monkeypatch):
    r = Recorder()
    monkeypatch.setattr(torch.cuda, "device", r.device)
    for mod in (fac_mod, mod_fac_mod):
        monkeypatch.setattr(mod, "load_library", lambda: FakeLib(r))
        monkeypatch.setattr(mod, "check_inputs", lambda *a: None)
        monkeypatch.setattr(mod, "stream_handle", lambda device: 0)
    for name in ("pack_bank_weight", "pack_bank_weight_tf32"):
        def recorded_pack(wk, name=name, pack=getattr(mod_fac_mod, name)):
            r.note(name)
            return pack(wk)

        monkeypatch.setattr(mod_fac_mod, name, recorded_pack)
    return r


def _t(shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def test_b1_launches_under_the_input_device(rec):
    x = _t((1, 4, 5, C))
    fac_mod._launch(x, _t((1, 4, 5, K * K * C)), K)
    assert rec.entered == [x.device]
    assert rec.calls == [("ebfi_fac_forward", True)]


def test_b1_band_mode_launches_under_the_input_device(rec):
    x = _t((1, 4 + K - 1, 5, C))  # the band's rows with their halo
    out = fac_mod._launch(x, _t((1, 4, 5, K * K * C)), K, band=True)
    assert out.shape == (1, 4, 5, C) and fac_mod.fac_band_cuda.launches >= 1
    assert rec.entered == [x.device]
    assert rec.calls == [("ebfi_fac_band_forward", True)]


PACKERS = {torch.bfloat16: "pack_bank_weight", torch.float32: "pack_bank_weight_tf32"}


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "ebfi_mod_fac_fused_wgmma"),
                                         (torch.float32, "ebfi_mod_fac_fused")])
def test_b3_packs_and_launches_under_the_input_device(rec, dtype, entry):
    ev, ff = _t((1, 4, 5, C), dtype), _t((1, 4, 5, C), dtype, 1)
    mod_fac_mod._launch_fused(ev, ff, _t((3, 3, 2 * C, K * K * C), dtype), _t((K * K * C,)), K)
    assert rec.entered == [ev.device]
    assert rec.calls == [(PACKERS[dtype], True), (entry, True)]


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "ebfi_mod_fac_shared_wgmma"),
                                         (torch.float32, "ebfi_mod_fac_shared")])
@pytest.mark.parametrize("packed", [False, True])
def test_b2_packs_and_launches_under_the_input_device(rec, dtype, entry, packed):
    ev, ff = _t((2, 4, 5, C), dtype), _t((1, 4, 5, C), dtype, 1)
    mod_fac_mod._launch_shared(ev, ff, _t((3, 3, 2 * C, K * K * C), dtype), _t((K * K * C,)), K,
                               packed)
    assert rec.entered == [ev.device]
    assert rec.calls == [(PACKERS[dtype], True)] * 2 + [(entry, True)]


def test_the_plain_backward_enters_no_guard(rec, monkeypatch):
    """The Function's forward launches (stubbed: the plain version's values
    under the guard), its backward recomputes through the plain version
    and enters no guard."""
    def launch(x, kernel, k):
        with torch.cuda.device(x.device):
            rec.note("launch")
        return fac_mod.fac_plain(x, kernel, k)

    monkeypatch.setattr(fac_mod, "_run", launch)
    x = _t((1, 4, 5, 8)).requires_grad_()
    bank = _t((1, 4, 5, K * K * 8), seed=2).requires_grad_()
    out = fac_mod.kernel_conv2d_cuda(x, bank, K)
    assert len(rec.entered) == 1
    out.sum().backward()
    assert len(rec.entered) == 1 and x.grad is not None and bank.grad is not None
