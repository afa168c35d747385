"""The f32 flash bodies at D 16, 32, 64, 128, 256 and 512 and the f32
wide ones (``flash_fwd_kernel_wide``, ``flash_dq_kernel_wide``,
``flash_dkv_kernel_wide``; D >= 1024) of this tree against the same
entry points built from another checkout's sources, or from this tree's
with one design choice changed, timed in turns in one process on the
card::

    python -m apex_tpu_torch.tools.flash_wide_f32 --other DIR [--kernels fwd,dq,dkv] [--widths 256,512,...]
    python -m apex_tpu_torch.tools.flash_wide_f32 --variant NAME[,NAME...] [--kernels dq,dkv] [--widths 32,16,proxy,proxy16]

``DIR`` holds the other ``flash_fwd.cu`` / ``flash_bwd.cu`` and their
headers (for instance ``apex_tpu_torch/csrc`` of an unpacked ``git
archive`` of an earlier commit).  A ``--variant`` (``VARIANTS``) is this
tree's ``flash_bwd.cu`` with constants of one geometry set anew
(``tools/variants.py``; the f32 dq's ``DqWide`` or dk/dv's ``DkvWide``
at W 16 and 32: CTAs an SM, 256 threads, 128-key or 128-row tiles, ring
stages), written beside the build.  Each source builds with the port's nvcc
flags into ``apex_tpu_torch/_build/`` (all at once) and is called
through its C entry points with the arguments the wrapper gives them.
At each f32 shape (causal: GPT-2 small's (8, 12, 512, 64), a Llama-class
(8, 8, 512, 128), (8, 4, 512) at D 256 and 512, D 1024, and 2048, 4096,
8192 at D 1024's bytes; GPT-2 small's batch, heads and seq at D 32 and
16; "proxy", the BERT example's default (8, 4, 512, 32) unmasked, the
shape it trains at ``--opt-level O0``, and "proxy16", the same at D 16,
where its heads of 9..16 are padded; ``--widths`` picks some) and
dropout rate each kernel of each source is held to its twin
(``flash_fwd_ref`` / ``flash_bwd_ref`` on this tree's o and lse) within
the f32 tolerance and to its own bits on a second call; then each
prints its device milliseconds a call (CUDA events around calls queued
behind a device spin, so the host's launching is hidden), in the order
this, other, other, this for each other source, with the useful TFLOP/s (4·D FLOP a visible
pair forward, 6·D dq, 8·D dk/dv) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os

from apex_tpu_torch.tools import variants

# name: (B, H, S, D, causal)
SHAPES = {str(d): (b, h, s, d, True) for b, h, s, d in (
    (8, 12, 512, 64), (8, 8, 512, 128), (8, 4, 512, 256), (8, 4, 512, 512),
    (8, 2, 512, 1024), (4, 2, 512, 2048), (2, 2, 512, 4096),
    (1, 2, 512, 8192), (8, 12, 512, 32), (8, 12, 512, 16))}
SHAPES["proxy"] = (8, 4, 512, 32, False)
SHAPES["proxy16"] = (8, 4, 512, 16, False)
TOL = dict(atol=1e-4, rtol=1e-4)
CTAS = "228 * 1024 / (SMEM + 1024)"         # the shipped CTAs an SM from 64
# name: [(the struct, its constant, the variant's expression)], each in
# csrc/flash_bwd.cu, changing the W-16 and W-32 bodies alone
VARIANTS = {
    "dq 2 CTAs": [("DqWide", "CTAS", f"W < 64 ? 2 : {CTAS}")],
    "dq 3 CTAs": [("DqWide", "CTAS", f"W < 64 ? 3 : {CTAS}")],
    "dkv 2 CTAs": [("DkvWide", "CTAS", f"W < 64 ? 2 : {CTAS}")],
    "dkv 3 CTAs": [("DkvWide", "CTAS", f"W < 64 ? 3 : {CTAS}")],
    "dq 256 threads": [("DqWide", "THREADS", "BwdWide::THREADS"),
                       ("DqWide", "CTAS", f"W < 64 ? 2 : {CTAS}")],
    "dkv 256 threads": [("DkvWide", "THREADS", "BwdWide::THREADS"),
                        ("DkvWide", "CTAS", f"W < 64 ? 2 : {CTAS}")],
    "dq 128-key tiles": [("DqWide", "THREADS", "BwdWide::THREADS"),
                         ("DqWide", "TILE", "W_ < 64 ? 128 : BwdWide::TILE"),
                         ("DqWide", "CTAS", f"W < 64 ? 2 : {CTAS}")],
    "dkv 128-row tiles": [("DkvWide", "THREADS", "BwdWide::THREADS"),
                          ("DkvWide", "TILE", "W_ < 64 ? 128 : BwdWide::TILE"),
                          ("DkvWide", "CTAS", f"W < 64 ? 1 : {CTAS}")],
    "dq 3 stages": [("DqWide", "STAGES",
                     "W < 64 ? 3 : DIRECT ? 2 : BwdWide::STAGES")],
    "dkv 3 stages": [("DkvWide", "STAGES", "W < 64 ? 3 : W <= 64 ? 2 : RING")],
}
# kernel: (source, C entry point, useful FLOP a visible pair / D)
KERNELS = {"fwd": ("flash_fwd", "apex_flash_fwd", 4),
           "dq": ("flash_bwd", "apex_flash_dq", 6),
           "dkv": ("flash_bwd", "apex_flash_dkv", 8)}
# the f32 wide bodies and the f32 CUDA-core bodies at 16..128, mangled
WIDE_F32 = r"_kernel_wideIf|_kernelIfLi(16|32|64|128)E"


def _build_pairs(others: dict, kernels) -> dict:
    """{(kernel, "this" | a name of ``others``): the C entry point}, this
    tree's sources and each other's ({name: a directory of sources, or
    the ``VARIANTS`` entry's changes}) compiled at once."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn
    argtypes = {"fwd": attn.FLASH_FWD.argtypes, "dq": attn.FLASH_DQ.argtypes,
                "dkv": attn.FLASH_DKV.argtypes}
    srcs = {}
    for lib in sorted({KERNELS[kn][0] for kn in kernels}):
        for name, other in (("this", _build.CSRC), *others.items()):
            if isinstance(other, str):
                src = os.path.join(other, f"{lib}.cu")
                if not os.path.exists(src):
                    raise RuntimeError(f"no {lib}.cu in {other}")
                srcs[lib, name] = (src, other)
            elif lib == "flash_bwd":
                srcs[lib, name] = (variants.write(
                    "wide_f32", f"{lib} {name}", variants.variant(lib, other)),
                    _build.CSRC)
            else:                       # a variant changes flash_bwd.cu alone
                srcs[lib, name] = (os.path.join(_build.CSRC, f"{lib}.cu"),
                                   _build.CSRC)
    built = variants.build("wide_f32", {f"{lib} {name}": src for (lib, name),
                                        src in srcs.items()})
    for key, (_, log) in built.items():
        for entry, regs, spill in variants.ptxas_lines(log, WIDE_F32):
            print(f"ptxas {key.split(' ', 1)[1]} {entry}: {regs}; {spill}",
                  flush=True)
    fns = {}
    for kn in kernels:
        lib, sym, _ = KERNELS[kn]
        for name in ("this", *others):
            fn = getattr(built[f"{lib} {name}"][0], sym)
            fn.argtypes, fn.restype = argtypes[kn], ctypes.c_int
            fns[kn, name] = fn
    return fns


def main(argv=None) -> int:
    import torch
    from apex_tpu_torch.ops import attention as attn
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--other",
                       help="the directory of the other flash_fwd.cu and "
                            "flash_bwd.cu")
    which.add_argument("--variant",
                       help="comma-separated names of VARIANTS: this "
                            "tree's sources with one design choice "
                            "changed, each timed against this tree")
    ap.add_argument("--kernels", default="fwd,dq,dkv",
                    help="comma-separated, of fwd, dq and dkv")
    ap.add_argument("--widths", default=",".join(SHAPES),
                    help="comma-separated names of the shapes to run (a "
                         "head dim, or proxy)")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    widths = args.widths.split(",")
    if not set(widths) <= set(SHAPES):
        raise SystemExit(f"--widths takes {list(SHAPES)}, got {widths}")
    shapes = [SHAPES[w] for w in widths]
    if not set(kernels) <= set(KERNELS):
        raise SystemExit(f"--kernels takes {sorted(KERNELS)}, got {kernels}")
    if not torch.cuda.is_available():
        raise SystemExit("flash_wide_f32 needs a CUDA card")
    smi = variants.card()
    if args.other:
        others = {"other": args.other}
    else:
        names = args.variant.split(",")
        if not set(names) <= set(VARIANTS):
            raise SystemExit(f"--variant takes {sorted(VARIANTS)}, got "
                             f"{names}")
        others = {n: VARIANTS[n] for n in names}
    fns = _build_pairs(others, kernels)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(5)
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    for b, h, s, d, causal in shapes:
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                       for _ in range(4))
        pairs = b * h * s * (s + 1) // 2 if causal else b * h * s * s
        mask = "causal" if causal else "unmasked"
        for rate in (0.0, 0.1):
            sd = seed if rate else None
            drop = attn._dropout_args(rate, sd, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            wo, wl = attn.flash_fwd_ref(q, k, v, causal, None, None, rate,
                                        sd)
            # the backward's inputs: this tree's forward, and di from it
            o, lse = attn._flash_fwd_cuda(q, k, v, causal, None, None, True,
                                          rate, sd)
            di = (do * o).sum(dim=-1)
            want = dict(zip(("dq", "dk", "dv"), attn.flash_bwd_ref(
                q, k, v, o, lse, do, causal, None, None, rate, sd)))
            want.update(o=wo, lse=wl)
            ins = (q.data_ptr(), k.data_ptr(), v.data_ptr())
            bwd_ins = ins + (do.data_ptr(), lse.data_ptr(), di.data_ptr())
            common = (0, b, h, h, s, s, d, int(causal), d ** -0.5, *drop,
                      stream)
            for kn in kernels:
                calls = {}
                for name in ("this", *others):
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
                        raise SystemExit(f"{kn} ({b}, {h}, {s}, {d}) {mask} rate "
                                         f"{rate}: the {name} source's bits "
                                         f"differ run to run")
                    for n, t in outs.items():
                        tol = (dict(atol=1e-4, rtol=1e-5) if n == "lse"
                               else TOL)
                        torch.testing.assert_close(t, want[n], **tol)
                    del first, outs
                flop = KERNELS[kn][2] * d * pairs
                for other in others:
                    ms = {"this": [], other: []}
                    for name in ("this", other, other, "this"):
                        ms[name].append(variants.device_ms(
                            calls[name], iters=10, warm=2))
                    print(f"flash {kn} ({b}, {h}, {s}, {d}) f32 {mask} "
                          f"dropout {rate}: " + "; ".join(
                              f"{n} " + " / ".join(f"{t:.4f}" for t in ts)
                              + f" ms ({flop / (sum(ts) / 2) / 1e9:.1f} "
                              "TFLOP/s)" for n, ts in ms.items())
                          + f" (each within the f32 tolerance of the twin) "
                            f"[{smi}]", flush=True)
                del calls
            del wo, wl, o, lse, di, want
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
