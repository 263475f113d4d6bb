"""P-6 / P-7: static against dynamic lane rotation.

Counterpart of `benchmarks/probe_roll.py` (`_kernel_static` l.38,
`_kernel_dynamic` l.46): `reps` times

    x = roll(x, s_i, axis=1) + 1,   out[:, j] = x[:, (j - s) mod 128]

(np.roll's direction) over int32 rows of 128 lanes, with s_i = 1 + i % 7
fixed when the kernel is compiled (`roll_static`) or s_i = s[i % 8] read
at run time (`roll_dynamic`). The kernels (`csrc/probe_roll.cu`) keep one
row per warp in registers and rotate by warp shuffles.

    python -m libgdf_tpu_torch.probes.roll [--device cpu]

prints the probe's lines (microseconds per call, ns per roll of the whole
block) and the dynamic / static ratio, on the probe's input: x the
arange of 512 x 128, s = 1 .. 8, 1024 repetitions.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import _common

ROWS, LANES, REPS = 512, 128, 1024
SHIFTS = 8                      # the length of the dynamic probe's s


def static_shifts(reps: int = REPS) -> list:
    return [1 + i % 7 for i in range(reps)]


def dynamic_shifts(s, reps: int = REPS) -> list:
    s = [int(v) for v in s]
    return [s[i % SHIFTS] for i in range(reps)]


def roll_plain(x: torch.Tensor, shifts) -> torch.Tensor:
    """The literal loop: x = torch.roll(x, s, 1) + 1 for each s."""
    for s in shifts:
        x = torch.roll(x, s, 1) + 1
    return x


def _check(x: torch.Tensor, reps: int) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != LANES:
        raise TypeError(f"roll: x must be int32 (rows, {LANES})")
    if reps < 0:
        raise ValueError(f"roll: reps {reps} < 0")


def _check_shifts(s: torch.Tensor) -> None:
    if s.dtype != torch.int32 or s.shape != (SHIFTS,):
        raise TypeError(f"roll_dynamic: s must be int32 ({SHIFTS},)")


def roll_static_plain(x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    _check(x, reps)
    return roll_plain(x, static_shifts(reps))


def roll_dynamic_plain(s: torch.Tensor, x: torch.Tensor,
                       reps: int = REPS) -> torch.Tensor:
    _check(x, reps)
    _check_shifts(s)
    return roll_plain(x, dynamic_shifts(s.tolist(), reps))


def roll_static(x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """`reps` rolls by 1 + i % 7, each followed by + 1."""
    _check(x, reps)
    if _common.on_cpu(x):
        return roll_static_plain(x, reps)
    out = torch.empty_like(x)
    _common.launch(roll_static, "roll_static", "gdf_probe_roll_static", x,
                   out, x.shape[0], reps)
    return out


def roll_dynamic(s: torch.Tensor, x: torch.Tensor,
                 reps: int = REPS) -> torch.Tensor:
    """`reps` rolls by s[i % 8] (any sign, taken mod 128), each followed by
    + 1; s int32 (8,) on x's device."""
    _check(x, reps)
    _check_shifts(s)
    if _common.on_cpu(s, x):
        return roll_dynamic_plain(s, x, reps)
    out = torch.empty_like(x)
    _common.launch(roll_dynamic, "roll_dynamic", "gdf_probe_roll_dynamic", s,
                   x, out, x.shape[0], reps)
    return out


roll_static.launches = 0
roll_dynamic.launches = 0


def numpy_roll(x: np.ndarray, shifts) -> np.ndarray:
    for s in shifts:
        x = np.roll(x, s, axis=1) + np.int32(1)
    return x


def probe_inputs():
    """The probe's x and s as numpy."""
    return (np.arange(ROWS * LANES, dtype=np.int32).reshape(ROWS, LANES),
            np.arange(1, SHIFTS + 1, dtype=np.int32))


def main(argv=None) -> int:
    args = _common.parser("roll", "Static against dynamic lane rotation."
                          ).parse_args(argv)
    dev = _common.device(args.device)
    if dev is None:
        return 1
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    x, s = probe_inputs()
    xt, st = torch.as_tensor(x, device=dev), torch.as_tensor(s, device=dev)
    runs = {"static": (lambda: roll_static(xt), static_shifts()),
            "dynamic": (lambda: roll_dynamic(st, xt), dynamic_shifts(s))}
    per_roll = {}
    for kind, (fn, shifts) in runs.items():
        _common.require(np.array_equal(fn().cpu().numpy(),
                                       numpy_roll(x, shifts)),
                        f"{kind} roll equals np.roll step by step")
        ms = _common.time_ms(fn, dev)
        per_roll[kind] = ms * 1e6 / REPS
        print(f"{kind}: {ms * 1e3:8.2f} us/call  {per_roll[kind]:7.1f} "
              f"ns/roll", flush=True)
    print(f"dynamic/static ratio: "
          f"{per_roll['dynamic'] / per_roll['static']:0.2f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
