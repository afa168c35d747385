"""The bf16 tensor-core forward, dq and dk/dv at head dims 16 and 32 (the
shipped ``FwdTc`` / ``DqTc`` / ``DkvTc`` geometry in ``csrc/flash_fwd.cu``
and ``csrc/flash_bwd.cu``) against variants of the same sources, each
with one constant of its geometry changed (``tools/variants.py``), timed
in turns in one process on the card::

    python -m apex_tpu_torch.tools.flash_narrow_tc [--variants NAME,...]

The variants (``VARIANTS``; a name starts with the kernel it changes)
change only the D-16 and D-32 bodies: the forward or the dq with 128-key
tiles (S = Q.K^T, and the dq's dP = dO.V^T, as m64n128k16: twice the
scores a tile) or padded to one CTA an SM (where the shipped bodies' few
KB of tiles let several share one), the dq with three K/V ring stages
(two shipped), the dk/dv with two or four q/dO ring stages (three
shipped) or one CTA an SM.  Every source builds with the port's nvcc
flags into ``apex_tpu_torch/_build/`` (all at once) and prints the ptxas
line (registers, spills) of each D-16/32 tensor-core body; each is
called through its C entry point with the arguments the wrapper gives
it.  At each bf16 shape (GPT-2 small's batch, heads and seq at D 32 and
16, causal; the BERT proxy's (8, 4, 512, 32) unmasked) and dropout
rate each variant is held to the twin (``flash_fwd_ref`` /
``flash_bwd_ref``) within the bf16 tolerance, then timed against the shipped body in the order shipped,
variant, variant, shipped (device milliseconds a call: CUDA events
around calls queued behind a device spin, so the host's launching is
hidden), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re

from apex_tpu_torch.tools import variants

# name: (source, the struct, its constant, the variant's expression)
VARIANTS = {
    "fwd 128-key tiles": ("flash_fwd", "FwdTc", "BK", "D < 64 ? 128 : TC_BK"),
    "fwd one CTA an SM": ("flash_fwd", "FwdTc", "SMEM",
                          "BAR_OFF + 2 * 8 + 1024 + "
                          "(D < 64 ? 120 * 1024 : 0)"),
    "dq 128-key tiles": ("flash_bwd", "DqTc", "BK", "D < 64 ? 128 : 64"),
    "dq 3 stages": ("flash_bwd", "DqTc", "STAGES", "D < 64 ? 3 : 2"),
    "dq one CTA an SM": ("flash_bwd", "DqTc", "SMEM",
                         "BAR_OFF + STAGES * 8 + 1024 + "
                         "(D < 64 ? 120 * 1024 : 0)"),
    "dkv 2 stages": ("flash_bwd", "DkvTc", "STAGES", "2"),
    "dkv 4 stages": ("flash_bwd", "DkvTc", "STAGES", "D < 64 ? 4 : 2"),
    "dkv one CTA an SM": ("flash_bwd", "DkvTc", "SMEM",
                          "BAR_OFF + (STAGES + 1) * 8 + 1024 + "
                          "(D < 64 ? 120 * 1024 : 0)"),
}
SHAPES = ((8, 12, 512, 32, True), (8, 12, 512, 16, True),
          (8, 4, 512, 32, False))                  # (B, H, S, D, causal)
TOL = dict(atol=2e-2, rtol=2e-2)        # chip_smoke.ATTN_TOL["bf16"]
KINDS = {"fwd": ("flash_fwd", "apex_flash_fwd", "FLASH_FWD"),
         "dq": ("flash_bwd", "apex_flash_dq", "FLASH_DQ"),
         "dkv": ("flash_bwd", "apex_flash_dkv", "FLASH_DKV")}
MARK = re.compile(r"flash_(fwd|dq|dkv)_kernel_tcILi(16|32)E")


def _build_variants(names) -> dict:
    """{(name, kind): the C entry point} for each named variant and the
    shipped source of its kind, every source compiled at once."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn
    srcs = {f"shipped {lib}": (os.path.join(_build.CSRC, f"{lib}.cu"),
                               _build.CSRC)
            for lib in sorted({VARIANTS[n][0] for n in names})}
    for n in names:
        lib, struct, const, expr = VARIANTS[n]
        srcs[n] = (variants.write("narrow", n, variants.variant(
            lib, [(struct, const, expr)])), _build.CSRC)
    libs = variants.build("narrow", srcs)
    for name, (_, log) in libs.items():
        for entry, regs, spill in variants.ptxas_lines(log, MARK.pattern):
            print(f"ptxas {name} {entry}: {regs}; {spill}", flush=True)
    fns = {}
    for n in names:
        kind = n.split()[0]
        lib, sym, kern = KINDS[kind]
        for name in (n, f"shipped {lib}"):
            fn = getattr(libs[name][0], sym)
            fn.argtypes = getattr(attn, kern).argtypes
            fn.restype = ctypes.c_int
            fns[name, kind] = fn
    return fns


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
    smi = variants.card()
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
                    ms[n].append(variants.device_ms(calls[n]))
                print(f"flash {kind} ({b}, {h}, {s}, {d}) bf16 causal="
                      f"{causal} dropout {rate}: " + "; ".join(
                          f"{n[0]} " + " / ".join(f"{t:.4f}" for t in ts)
                          + " ms" for n, ts in ms.items())
                      + f" (each within the bf16 tolerance of the twin) "
                      f"[{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
