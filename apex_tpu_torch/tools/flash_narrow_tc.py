"""The bf16 tensor-core forward and dk/dv at head dims 16 and 32 (the
shipped ``FwdTc`` / ``DkvTc`` geometry in ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``) against variants of the same sources, each with one
line changed, timed in turns in one process on the card::

    python -m apex_tpu_torch.tools.flash_narrow_tc [--variants NAME,...]

The variants (``VARIANTS``) change only the D-16 and D-32 bodies: the
forward with 128-key tiles (S = Q.K^T as m64n128k16, twice the softmax
a tile) or padded to one CTA an SM (where the shipped bodies' few KB of
tiles let several share one), the dk/dv with two or four q/dO ring
stages (three shipped) or one CTA an SM.  Every source builds with the port's nvcc flags
into ``apex_tpu_torch/_build/`` (all at once) and prints the ptxas line
of each D-16/32 body; each is called through its C entry point with the
arguments the wrapper gives it.  At each bf16 shape (GPT-2 small's batch,
heads and seq at D 32 and 16, causal; the BERT proxy's (8, 4, 512, 32)
unmasked) and dropout rate each variant is held to the twin
(``flash_fwd_ref`` / ``flash_bwd_ref``) within the bf16 tolerance, then
timed against the shipped body in the order shipped, variant, variant,
shipped (device milliseconds a call: CUDA events around calls queued
behind a device spin, so the host's launching is hidden), with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess

# name: (source, the shipped line, the variant's line)
VARIANTS = {
    "fwd 128-key tiles": (
        "flash_fwd", "static constexpr int BK = TC_BK;",
        "static constexpr int BK = D < 64 ? 128 : TC_BK;"),
    "fwd one CTA an SM": (
        "flash_fwd", "static constexpr int SMEM = BAR_OFF + 2 * 8 + 1024;",
        "static constexpr int SMEM = BAR_OFF + 2 * 8 + 1024 + "
        "(D < 64 ? 120 * 1024 : 0);"),
    "dkv 2 stages": (
        "flash_bwd", "static constexpr int STAGES = D < 64 ? 3 : 2;",
        "static constexpr int STAGES = 2;"),
    "dkv 4 stages": (
        "flash_bwd", "static constexpr int STAGES = D < 64 ? 3 : 2;",
        "static constexpr int STAGES = D < 64 ? 4 : 2;"),
    "dkv one CTA an SM": (
        "flash_bwd",
        "BAR_OFF = ROW_OFF + 3 * STAGES * BQT * 4;\n"
        "  static constexpr int SMEM = BAR_OFF + (STAGES + 1) * 8 + 1024;",
        "BAR_OFF = ROW_OFF + 3 * STAGES * BQT * 4;\n"
        "  static constexpr int SMEM = BAR_OFF + (STAGES + 1) * 8 + 1024 + "
        "(D < 64 ? 120 * 1024 : 0);"),
}
SHAPES = ((8, 12, 512, 32, True), (8, 12, 512, 16, True),
          (8, 4, 512, 32, False))                  # (B, H, S, D, causal)
TOL = dict(atol=2e-2, rtol=2e-2)        # chip_smoke.ATTN_TOL["bf16"]
ENTRY = {"flash_fwd": "apex_flash_fwd", "flash_bwd": "apex_flash_dkv"}
MARK = {"flash_fwd": "flash_fwd_kernel_tcILi", "flash_bwd":
        "flash_dkv_kernel_tcILi"}


def _stem(name: str) -> str:
    from apex_tpu_torch import _build
    return os.path.join(_build.BUILD_DIR, "narrow_" + re.sub(r"\W+", "_",
                                                            name))


def _build_variants(names) -> dict:
    """{name: the C entry point}: "shipped fwd" / "shipped dkv" and each
    named variant, every source compiled at once."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    srcs = {}
    for lib in sorted({VARIANTS[n][0] for n in names}):
        with open(os.path.join(_build.CSRC, f"{lib}.cu")) as f:
            srcs[f"shipped {lib}"] = (lib, f.read())
    for n in names:
        lib, old, new = VARIANTS[n]
        text = srcs[f"shipped {lib}"][1]
        if text.count(old) != 1:
            raise RuntimeError(f"csrc/{lib}.cu lacks {old!r} (once)")
        srcs[n] = (lib, text.replace(old, new))
    procs = {}
    for name, (lib, text) in srcs.items():
        with open(_stem(name) + ".cu", "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
             "-o", _stem(name) + ".so", _stem(name) + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        lib = srcs[name][0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        entry = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "Used" in line and entry and MARK[lib] in entry and (
                    "ILi16E" in entry or "ILi32E" in entry):
                print(f"ptxas {name} {entry}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
        fn = getattr(ctypes.CDLL(_stem(name) + ".so"), ENTRY[lib])
        fn.argtypes = (attn.FLASH_FWD if lib == "flash_fwd"
                       else attn.FLASH_DKV).argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _device_ms(call, iters: int = 50) -> float:
    import torch
    for _ in range(3):
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
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default=",".join(VARIANTS))
    names = [n.strip() for n in p.parse_args(argv).variants.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("flash_narrow_tc needs a CUDA card")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"no variants {unknown} (of {sorted(VARIANTS)})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    fns = _build_variants(names)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(3)
    seed = torch.tensor([99], dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for b, h, s, d, causal in SHAPES:
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        for rate in (0.0, 0.1):
            sd = seed if rate else None
            drop = attn._dropout_args(rate, sd, dev)
            wo, wlse = attn.flash_fwd_ref(q, k, v, causal, None, None, rate,
                                          sd)
            _, wdk, wdv = attn.flash_bwd_ref(q, k, v, wo, wlse, do, causal,
                                             None, None, rate, sd)
            di = (do.float() * wo.float()).sum(dim=-1)
            calls, outs = {}, {}
            for name, fn in fns.items():
                if name.startswith("shipped flash_fwd") or name.startswith(
                        "fwd"):
                    o = torch.empty_like(q)
                    lse = torch.empty(b * h, s, device=dev)
                    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), None, None, 1, b,
                            h, h, s, s, d, int(causal), d ** -0.5, *drop,
                            stream)
                    outs[name] = ((o, wo), (lse, wlse))
                else:
                    dk, dv = torch.empty_like(k), torch.empty_like(v)
                    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), wlse.data_ptr(), di.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), None, None, 1, b,
                            h, h, s, s, d, int(causal), d ** -0.5, *drop,
                            stream)
                    outs[name] = ((dk, wdk), (dv, wdv))
                calls[name] = lambda fn=fn, args=args, keep=outs[name]: fn(
                    *args)
                if calls[name]() != 0:
                    raise RuntimeError(f"{name} did not launch")
            torch.cuda.synchronize()
            for name, pairs in outs.items():
                for i, (got, want) in enumerate(pairs):
                    if got.dtype == torch.float32:    # lse
                        torch.testing.assert_close(got, want, atol=1e-4,
                                                   rtol=1e-5)
                    else:
                        torch.testing.assert_close(got, want, **TOL)
            for name in names:
                lib = VARIANTS[name][0]
                base = f"shipped {lib}"
                ms = {base: [], name: []}
                for n in (base, name, name, base):
                    ms[n].append(_device_ms(calls[n]))
                print(f"flash {'forward' if lib == 'flash_fwd' else 'dk/dv'}"
                      f" ({b}, {h}, {s}, {d}) bf16 causal={causal} dropout "
                      f"{rate}: " + "; ".join(
                          f"{n} " + " / ".join(f"{t:.4f}" for t in ts)
                          + " ms" for n, ts in ms.items())
                      + f" (each within the bf16 tolerance of the twin) "
                      f"[{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
