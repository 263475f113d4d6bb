"""libgdf_tpu_torch's RMM surface against libgdf_tpu's, on the CPU: the
alloc / realloc / free lifecycles, the error codes and the CSV event log,
whose header and event order are exact."""
import numpy as np
import pytest
import torch

from libgdf_tpu import memory as jrmm
from libgdf_tpu_torch import GDFError
from libgdf_tpu_torch import memory as rmm
from libgdf_tpu_torch.memory import manager


@pytest.fixture(autouse=True)
def _init():
    rmm.rmmInitialize()
    jrmm.rmmInitialize()
    yield
    rmm.rmmFinalize()
    jrmm.rmmFinalize()


def test_surface_matches():
    assert set(rmm.__all__) == set(jrmm.__all__)
    for enum in ("rmmError_t", "rmmAllocationMode"):
        assert [(e.name, e.value) for e in getattr(rmm, enum)] == \
            [(e.name, e.value) for e in getattr(jrmm, enum)]
    assert manager._LOG_COLUMNS == jrmm.manager._LOG_COLUMNS
    assert rmm.rmmOptions_t() == rmm.rmmOptions_t(
        rmm.rmmAllocationMode.PoolAllocation, 0, True)
    assert rmm.initialize is rmm.rmmInitialize
    assert rmm.rmmIsInitialized()


def test_alloc_free_lifecycle():
    h = rmm.rmmAlloc(1024, dtype=np.float32, device="cpu")
    arr = rmm.rmmGetArray(h)
    assert arr.shape == (1024,) and arr.dtype == torch.float32
    assert not arr.any()
    assert rmm.rmmFree(h) == rmm.rmmError_t.RMM_SUCCESS
    with pytest.raises(rmm.RMMError) as e:
        rmm.rmmFree(h)
    assert e.value.errcode == rmm.rmmError_t.RMM_ERROR_INVALID_ARGUMENT


def test_zero_and_large_sizes():
    h0 = rmm.rmmAlloc(0, device="cpu")
    assert rmm.rmmGetArray(h0).shape == (0,)
    assert rmm.rmmGetArray(h0).dtype == torch.uint8
    rmm.rmmFree(h0)
    h = rmm.rmmAlloc(1 << 20, dtype=torch.int64, device="cpu")
    assert rmm.rmmGetArray(h).shape == (1 << 20,)
    rmm.rmmFree(h)


def test_alloc_goes_to_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(GDFError, match="device='cpu'"):
        rmm.rmmAlloc(16)
    with pytest.raises(GDFError, match="device='cpu'"):
        rmm.to_device(np.arange(4))
    assert rmm.rmmGetInfo() == (0, 0)


def test_realloc_preserves_prefix():
    h = rmm.rmmAlloc(8, dtype=np.int32, device="cpu")
    rmm.rmmGetArray(h).copy_(torch.arange(8, dtype=torch.int32))
    assert rmm.rmmRealloc(h, 16) == h
    out = rmm.rmmGetArray(h)
    assert out.shape == (16,) and out.dtype == torch.int32
    assert out.tolist() == list(range(8)) + [0] * 8
    rmm.rmmRealloc(h, 4)
    assert rmm.rmmGetArray(h).tolist() == [0, 1, 2, 3]
    assert rmm.device_array_from_handle(h, 2).tolist() == [0, 1]
    with pytest.raises(rmm.RMMError):
        rmm.rmmRealloc(h + 100, 4)


def test_not_initialized_errors():
    rmm.rmmFinalize()
    assert not rmm.rmmIsInitialized()
    for call in (lambda: rmm.rmmAlloc(4, device="cpu"),
                 lambda: rmm.rmmFree(1), lambda: rmm.rmmGetInfo(),
                 lambda: rmm.rmmRealloc(1, 2),
                 lambda: rmm.to_device(np.zeros(2), device="cpu")):
        with pytest.raises(rmm.RMMError) as e:
            call()
        assert e.value.errcode == rmm.rmmError_t.RMM_ERROR_NOT_INITIALIZED
    rmm.rmmInitialize()


def _events(mod, **kw):
    h1 = mod.rmmAlloc(256, **kw)
    mod.rmmRealloc(h1, 512)
    mod.rmmFree(h1)
    return mod.csv_log()


def test_csv_event_log(tmp_path):
    log = _events(rmm, device="cpu")
    jlog = _events(jrmm)
    lines, jlines = log.strip().splitlines(), jlog.strip().splitlines()
    assert lines[0] == jlines[0]
    assert lines[0].startswith("Event Type,Device ID,Address")
    assert len(lines[0].split(",")) == 11
    assert [ln.split(",")[0] for ln in lines[1:]] == \
        [ln.split(",")[0] for ln in jlines[1:]] == \
        ["Alloc", "Realloc", "Free"]
    # event, device, stream, size, current allocations (handles go on
    # counting across rmmInitialize in both packages)
    for ln, jln in zip(lines[1:], jlines[1:]):
        f, jf = ln.split(","), jln.split(",")
        assert f[:2] + f[3:5] + f[7:8] == jf[:2] + jf[3:5] + jf[7:8]
        assert f[2].startswith("0x")
        assert float(f[9]) >= float(f[8]) and float(f[10]) >= 0
    assert rmm.rmmLogSize() == len(log)
    p = tmp_path / "rmm.csv"
    assert rmm.rmmWriteLog(str(p)) == rmm.rmmError_t.RMM_SUCCESS
    assert p.read_text() == log == rmm.rmmGetLog()


def test_logging_can_be_turned_off():
    rmm.rmmInitialize(rmm.rmmOptions_t(enable_logging=False))
    rmm.rmmFree(rmm.rmmAlloc(4, device="cpu"))
    assert len(rmm.rmmGetLog().strip().splitlines()) == 1


def test_get_info_and_error_strings():
    free, total = rmm.rmmGetInfo()
    assert free >= 0 and total >= 0
    for code in (0, 3, 6, 99):
        assert rmm.rmmGetErrorString(code) == jrmm.rmmGetErrorString(code)
    assert rmm.rmmGetErrorString(3) == "RMM_ERROR_NOT_INITIALIZED"
    assert rmm.rmmGetAllocationOffset(1) == 0


def test_to_device_logs():
    arr = rmm.to_device(np.arange(10, dtype=np.int64), device="cpu")
    assert arr.dtype == torch.int64 and arr.tolist() == list(range(10))
    lines = rmm.csv_log().strip().splitlines()
    assert lines[1].split(",")[0] == "Alloc"
    assert lines[1].split(",")[4] == "80"
    t = torch.arange(3)
    assert rmm.to_device(t) is t or rmm.to_device(t).tolist() == [0, 1, 2]
