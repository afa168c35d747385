"""The f32 flash bodies at D 16, 32, 64, 128, 256 and 512 and the f32
wide ones (``flash_fwd_kernel_wide``, ``flash_dq_kernel_wide``,
``flash_dkv_kernel_wide``; D >= 1024) of this tree against the same
entry points built from another checkout's sources, timed in turns in
one process on the card::

    python -m apex_tpu_torch.tools.flash_wide_f32 --other DIR [--kernels fwd,dq,dkv] [--widths 256,512,...]

``DIR`` holds the other ``flash_fwd.cu`` / ``flash_bwd.cu`` and their
headers (for instance ``apex_tpu_torch/csrc`` of an unpacked ``git
archive`` of an earlier commit).  Each source builds with the port's nvcc
flags into ``apex_tpu_torch/_build/`` (all at once) and is called
through its C entry points with the arguments the wrapper gives them.
At each causal f32 shape (GPT-2 small's (8, 12, 512, 64), a Llama-class
(8, 8, 512, 128), (8, 4, 512) at D 256 and 512, D 1024, and 2048, 4096,
8192 at D 1024's bytes; GPT-2 small's batch, heads and seq at D 32 and
16; ``--widths`` picks some) and
dropout rate each kernel of each source is held to its twin
(``flash_fwd_ref`` / ``flash_bwd_ref`` on this tree's o and lse) within
the f32 tolerance and to its own bits on a second call; then each
prints its device milliseconds a call (CUDA events around calls queued
behind a device spin, so the host's launching is hidden), in the order
this, other, other, this, with the useful TFLOP/s (4·D FLOP a visible
pair forward, 6·D dq, 8·D dk/dv) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess

SHAPES = ((8, 12, 512, 64), (8, 8, 512, 128),
          (8, 4, 512, 256), (8, 4, 512, 512), (8, 2, 512, 1024),
          (4, 2, 512, 2048), (2, 2, 512, 4096),
          (1, 2, 512, 8192), (8, 12, 512, 32),
          (8, 12, 512, 16))                               # (B, H, S, D)
TOL = dict(atol=1e-4, rtol=1e-4)
# kernel: (source, C entry point, useful FLOP a visible pair / D)
KERNELS = {"fwd": ("flash_fwd", "apex_flash_fwd", 4),
           "dq": ("flash_bwd", "apex_flash_dq", 6),
           "dkv": ("flash_bwd", "apex_flash_dkv", 8)}


def _build_pairs(other: str, kernels) -> dict:
    """{(kernel, "this" | "other"): the C entry point}, every source
    compiled at once."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn
    argtypes = {"fwd": attn.FLASH_FWD.argtypes, "dq": attn.FLASH_DQ.argtypes,
                "dkv": attn.FLASH_DKV.argtypes}
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for lib in sorted({KERNELS[kn][0] for kn in kernels}):
        for name, src_dir in (("this", _build.CSRC), ("other", other)):
            src = os.path.join(src_dir, f"{lib}.cu")
            if not os.path.exists(src):
                raise RuntimeError(f"no {lib}.cu in {src_dir}")
            stem = os.path.join(_build.BUILD_DIR, f"{lib}_wide_f32_{name}")
            procs[lib, name] = (stem, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", src_dir,
                 "-o", f"{stem}.so", src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (lib, name), (stem, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} {lib}.cu:\n{out}")
        for entry, regs, spill in _ptxas_wide_f32(out):
            print(f"ptxas {name} {entry}: {regs}; {spill}", flush=True)
        libs[lib, name] = ctypes.CDLL(f"{stem}.so")
    fns = {}
    for kn in kernels:
        lib, sym, _ = KERNELS[kn]
        for name in ("this", "other"):
            fn = getattr(libs[lib, name], sym)
            fn.argtypes, fn.restype = argtypes[kn], ctypes.c_int
            fns[kn, name] = fn
    return fns


def _ptxas_wide_f32(log: str) -> list:
    """(kernel, registers, spills) of each f32 wide body (and of the f32
    CUDA-core bodies at 16, 32, 64 and 128, ``..._kernelIfLi16E`` ..
    ``...Li128E``) in nvcc's ``-Xptxas -v`` report."""
    out, entry, spill = [], None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], None
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry \
                and ("_kernel_wideIf" in entry or re.search(
                    r"_kernelIfLi(16|32|64|128)E", entry)):
            out.append((entry, line.split(":", 1)[-1].strip(), spill))
    return out


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
                    help="the directory of the other flash_fwd.cu and "
                         "flash_bwd.cu")
    ap.add_argument("--kernels", default="fwd,dq,dkv",
                    help="comma-separated, of fwd, dq and dkv")
    ap.add_argument("--widths", default=",".join(str(x[3]) for x in SHAPES),
                    help="comma-separated head dims of the shapes to run")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    widths = [int(w) for w in args.widths.split(",")]
    shapes = [x for x in SHAPES if x[3] in widths]
    if len(shapes) != len(widths):
        raise SystemExit(f"--widths takes {[x[3] for x in SHAPES]}, got "
                         f"{widths}")
    if not set(kernels) <= set(KERNELS):
        raise SystemExit(f"--kernels takes {sorted(KERNELS)}, got {kernels}")
    if not torch.cuda.is_available():
        raise SystemExit("flash_wide_f32 needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    fns = _build_pairs(args.other, kernels)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(5)
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    for b, h, s, d in shapes:
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                       for _ in range(4))
        pairs = b * h * s * (s + 1) // 2
        for rate in (0.0, 0.1):
            sd = seed if rate else None
            drop = attn._dropout_args(rate, sd, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            wo, wl = attn.flash_fwd_ref(q, k, v, True, None, None, rate, sd)
            # the backward's inputs: this tree's forward, and di from it
            o, lse = attn._flash_fwd_cuda(q, k, v, True, None, None, True,
                                          rate, sd)
            di = (do * o).sum(dim=-1)
            want = dict(zip(("dq", "dk", "dv"), attn.flash_bwd_ref(
                q, k, v, o, lse, do, True, None, None, rate, sd)))
            want.update(o=wo, lse=wl)
            ins = (q.data_ptr(), k.data_ptr(), v.data_ptr())
            bwd_ins = ins + (do.data_ptr(), lse.data_ptr(), di.data_ptr())
            common = (0, b, h, h, s, s, d, 1, d ** -0.5, *drop, stream)
            for kn in kernels:
                calls = {}
                for name in ("this", "other"):
                    fn = fns[kn, name]
                    if kn == "fwd":
                        outs = {"o": torch.empty_like(q),
                                "lse": torch.empty(b * h, s, device=dev)}
                        args_ = ins + (outs["o"].data_ptr(),
                                       outs["lse"].data_ptr(), None, None)
                    elif kn == "dq":
                        outs = {"dq": torch.empty_like(q)}
                        args_ = bwd_ins + (outs["dq"].data_ptr(), None, None)
                    else:
                        outs = {"dk": torch.empty_like(k),
                                "dv": torch.empty_like(v)}
                        args_ = bwd_ins + (outs["dk"].data_ptr(),
                                           outs["dv"].data_ptr(), None, None)
                    # the call holds its outputs, whose pointers it passes
                    calls[name] = (lambda fn=fn, a=args_, keep=outs:
                                   fn(*a, *common))
                    if calls[name]() != 0:
                        raise RuntimeError(f"the {name} {kn} did not launch")
                    first = {n: t.clone() for n, t in outs.items()}
                    calls[name]()
                    torch.cuda.synchronize()
                    if not all(torch.equal(first[n], t)
                               for n, t in outs.items()):
                        raise SystemExit(f"{kn} ({b}, {h}, {s}, {d}) rate "
                                         f"{rate}: the {name} source's bits "
                                         f"differ run to run")
                    for n, t in outs.items():
                        tol = (dict(atol=1e-4, rtol=1e-5) if n == "lse"
                               else TOL)
                        torch.testing.assert_close(t, want[n], **tol)
                    del first, outs
                ms = {name: [] for name in calls}
                for name in ("this", "other", "other", "this"):
                    ms[name].append(_device_ms(calls[name]))
                flop = KERNELS[kn][2] * d * pairs
                print(f"flash {kn} ({b}, {h}, {s}, {d}) f32 causal dropout "
                      f"{rate}: " + "; ".join(
                          f"{n} " + " / ".join(f"{t:.4f}" for t in ts)
                          + f" ms ({flop / (sum(ts) / 2) / 1e9:.1f} TFLOP/s)"
                          for n, ts in ms.items())
                      + f" (each within the f32 tolerance of the twin) "
                        f"[{smi}]", flush=True)
                del calls
            del wo, wl, o, lse, di, want
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
