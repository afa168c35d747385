"""The f32 wide flash forward (``flash_fwd_kernel_wide``, D >= 1024) of
this tree against the same entry point built from another checkout's
sources, timed in turns in one process on the card::

    python -m apex_tpu_torch.tools.flash_fwd_wide_f32 --other DIR

``DIR`` holds the other ``flash_fwd.cu`` and its headers (for instance
``apex_tpu_torch/csrc`` of an unpacked ``git archive`` of an earlier
commit).  Both build with the port's nvcc flags into
``apex_tpu_torch/_build/`` and are called through their C entry points
with the arguments the wrapper gives them.  At each causal f32 shape
(D 1024, and 2048, 4096, 8192 at D 1024's bytes) and dropout rate each
is held to ``flash_fwd_ref`` within the f32 tolerance and to its own
bits on a second call; then each prints its device milliseconds a call
(CUDA events around calls queued behind a device spin, so the host's
launching is hidden), in the order this, other, other, this, with the
useful TFLOP/s (4·D FLOP a visible pair) and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

SHAPES = ((8, 2, 512, 1024), (4, 2, 512, 2048), (2, 2, 512, 4096),
          (1, 2, 512, 8192))                              # (B, H, S, D)
TOL = dict(atol=1e-4, rtol=1e-4)


def _build_pair(other: str) -> dict:
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src_dir in (("this", _build.CSRC), ("other", other)):
        src = os.path.join(src_dir, "flash_fwd.cu")
        if not os.path.exists(src):
            raise RuntimeError(f"no flash_fwd.cu in {src_dir}")
        stem = os.path.join(_build.BUILD_DIR, f"flash_fwd_wide_f32_{name}")
        procs[name] = (stem, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", src_dir,
             "-o", f"{stem}.so", src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (stem, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} source:\n{out}")
        fn = ctypes.CDLL(f"{stem}.so").apex_flash_fwd
        fn.argtypes, fn.restype = attn.FLASH_FWD.argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _device_ms(call, iters: int = 10) -> float:
    import torch
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)         # ~0.1 s: outlasts the launches
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    import torch
    from apex_tpu_torch.ops import attention as attn
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="the directory of the other flash_fwd.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_wide_f32 needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    fns = _build_pair(args.other)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(5)
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    for b, h, s, d in SHAPES:
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   for _ in range(3))
        pairs = b * h * s * (s + 1) // 2
        for rate in (0.0, 0.1):
            sd = seed if rate else None
            drop = attn._dropout_args(rate, sd, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            wo, wl = attn.flash_fwd_ref(q, k, v, True, None, None, rate, sd)
            calls = {}
            for name, fn in fns.items():
                o = torch.empty_like(q)
                lse = torch.empty(b * h, s, device=dev)
                calls[name] = (lambda fn=fn, o=o, lse=lse: fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), None, None, 0, b, h, h, s, s, d, 1,
                    d ** -0.5, *drop, stream))
                if calls[name]() != 0:
                    raise RuntimeError(f"the {name} source did not launch")
                first = (o.clone(), lse.clone())
                calls[name]()
                torch.cuda.synchronize()
                if not (torch.equal(first[0], o) and torch.equal(first[1], lse)):
                    raise SystemExit(f"({b}, {h}, {s}, {d}) rate {rate}: the "
                                     f"{name} source's bits differ run to run")
                torch.testing.assert_close(o, wo, **TOL)
                torch.testing.assert_close(lse, wl, atol=1e-4, rtol=1e-5)
            ms = {name: [] for name in fns}
            for name in ("this", "other", "other", "this"):
                ms[name].append(_device_ms(calls[name]))
            print(f"flash forward ({b}, {h}, {s}, {d}) f32 causal dropout "
                  f"{rate}: " + "; ".join(
                      f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " ms ("
                      + f"{4.0 * d * pairs / (sum(ts) / 2) / 1e9:.1f} TFLOP/s)"
                      for n, ts in ms.items())
                  + f" (each within the f32 tolerance of the twin) [{smi}]",
                  flush=True)
            del wo, wl, calls
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
