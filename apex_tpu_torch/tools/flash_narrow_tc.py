"""The bf16 tensor-core forward, dq and dk/dv at head dims 16 and 32 (the
shipped ``FwdTc`` / ``DqTc`` / ``DkvTc`` geometry in ``csrc/flash_fwd.cu``
and ``csrc/flash_bwd.cu``) against variants of the same sources, each
with one line changed, timed in turns in one process on the card::

    python -m apex_tpu_torch.tools.flash_narrow_tc [--variants NAME,...]

The variants (``VARIANTS``; a name starts with the kernel it changes)
change only the D-16 and D-32 bodies: the forward or the dq with 128-key
tiles (S = Q.K^T, and the dq's dP = dO.V^T, as m64n128k16: twice the
scores a tile) or padded to one CTA an SM (where the shipped bodies' few
KB of tiles let several share one), the dq with three K/V ring stages
(two shipped), the dk/dv with two or four q/dO ring stages (three
shipped) or one CTA an SM.  Every source builds with the port's nvcc
flags into ``apex_tpu_torch/_build/`` (all at once) and prints the ptxas
line of each D-16/32 tensor-core body; each is called through its C
entry point with the arguments the wrapper gives it.  At each bf16 shape
(GPT-2 small's batch, heads and seq at D 32 and 16, causal; the BERT
proxy's (8, 4, 512, 32) unmasked) and dropout rate each variant is held
to the twin (``flash_fwd_ref`` / ``flash_bwd_ref``) within the bf16
tolerance, then timed against the shipped body in the order shipped,
variant, variant, shipped (device milliseconds a call: CUDA events
around calls queued behind a device spin, so the host's launching is
hidden), with the card's name and power limit.
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
    "dq 128-key tiles": (
        "flash_bwd", "static constexpr int BK = 64;                 "
        "// keys a ring stage",
        "static constexpr int BK = D < 64 ? 128 : 64;"),
    "dq 3 stages": (
        "flash_bwd", "static constexpr int STAGES = 2;              "
        "// K/V ring stages",
        "static constexpr int STAGES = D < 64 ? 3 : 2;"),
    "dq one CTA an SM": (
        "flash_bwd", "static constexpr int SMEM = BAR_OFF + STAGES * 8 + "
        "1024;",
        "static constexpr int SMEM = BAR_OFF + STAGES * 8 + 1024 + "
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
KINDS = {"fwd": ("flash_fwd", "apex_flash_fwd", "FLASH_FWD"),
         "dq": ("flash_bwd", "apex_flash_dq", "FLASH_DQ"),
         "dkv": ("flash_bwd", "apex_flash_dkv", "FLASH_DKV")}
MARK = re.compile(r"flash_(fwd|dq|dkv)_kernel_tcILi(16|32)E")


def _stem(name: str) -> str:
    from apex_tpu_torch import _build
    return os.path.join(_build.BUILD_DIR, "narrow_" + re.sub(r"\W+", "_",
                                                            name))


def _build_variants(names) -> dict:
    """{(name, kind): the C entry point} for each named variant and the
    shipped source of its kind, every source compiled at once."""
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
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        entry = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "Used" in line and entry and MARK.search(entry):
                print(f"ptxas {name} {entry}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
        libs[name] = ctypes.CDLL(_stem(name) + ".so")
    fns = {}
    for n in names:
        kind = n.split()[0]
        lib, sym, kern = KINDS[kind]
        for name in (n, f"shipped {lib}"):
            fn = getattr(libs[name], sym)
            fn.argtypes = getattr(attn, kern).argtypes
            fn.restype = ctypes.c_int
            fns[name, kind] = fn
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
            wdq, wdk, wdv = attn.flash_bwd_ref(q, k, v, wo, wlse, do, causal,
                                               None, None, rate, sd)
            di = (do.float() * wo.float()).sum(dim=-1)
            calls, outs = {}, {}
            for (name, kind), fn in fns.items():
                if kind == "fwd":
                    o = torch.empty_like(q)
                    lse = torch.empty(b * h, s, device=dev)
                    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr())
                    pairs = ((o, wo), (lse, wlse))
                elif kind == "dq":
                    dq = torch.empty_like(q)
                    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), wlse.data_ptr(), di.data_ptr(),
                            dq.data_ptr())
                    pairs = ((dq, wdq),)
                else:
                    dk, dv = torch.empty_like(k), torch.empty_like(v)
                    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), wlse.data_ptr(), di.data_ptr(),
                            dk.data_ptr(), dv.data_ptr())
                    pairs = ((dk, wdk), (dv, wdv))
                args += (None, None, 1, b, h, h, s, s, d, int(causal),
                         d ** -0.5, *drop, stream)
                outs[name, kind] = pairs
                # the call holds its outputs, whose pointers it passes
                calls[name, kind] = lambda fn=fn, args=args, keep=pairs: fn(
                    *args)
                if calls[name, kind]() != 0:
                    raise RuntimeError(f"{name} ({kind}) did not launch")
            torch.cuda.synchronize()
            for pairs in outs.values():
                for got, want in pairs:
                    if got.dtype == torch.float32:    # lse
                        torch.testing.assert_close(got, want, atol=1e-4,
                                                   rtol=1e-5)
                    else:
                        torch.testing.assert_close(got, want, **TOL)
            for name in names:
                kind = name.split()[0]
                base = (f"shipped {VARIANTS[name][0]}", kind)
                ms = {base: [], (name, kind): []}
                for n in (base, (name, kind), (name, kind), base):
                    ms[n].append(_device_ms(calls[n]))
                print(f"flash {kind} ({b}, {h}, {s}, {d}) bf16 causal="
                      f"{causal} dropout {rate}: " + "; ".join(
                          f"{n[0]} " + " / ".join(f"{t:.4f}" for t in ts)
                          + " ms" for n, ts in ms.items())
                      + f" (each within the bf16 tolerance of the twin) "
                      f"[{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
