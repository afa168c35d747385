"""The bf16 D-256 tensor-core flash forward with one K/V ring stage (the
shipped design, ``FwdTc::STAGES`` in ``csrc/flash_fwd.cu``) against the
same body with two stages, timed in turns in one process on the card::

    python -m apex_tpu_torch.tools.flash_fwd_stages

The two-stage copy is ``csrc/flash_fwd.cu`` with ``FwdTc::STAGES`` set
to 2 (``tools/variants.py``); both build with the port's nvcc flags into
``apex_tpu_torch/_build/`` and are called through their C entry points
with the arguments the wrapper gives them.  At each causal shape and
dropout rate it checks that the two give the same bits and are within
the bf16 tolerance of ``flash_fwd_ref``, then prints each variant's
device milliseconds a call (CUDA events around calls queued behind a
device spin, so the host's launching is hidden), in the order one, two,
two, one, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os

from apex_tpu_torch.tools import variants

SHAPES = ((8, 4, 512, 256), (16, 8, 512, 256), (4, 8, 1024, 256),
          (2, 4, 2048, 256), (1, 8, 4096, 256))          # (B, H, S, D)
TWO_STAGES = [("FwdTc", "STAGES", "2")]   # (struct, constant, expression)


def _build_variants() -> dict:
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention as attn
    two = variants.write("flash_fwd_stages", "two stages", variants.variant(
        "flash_fwd", TWO_STAGES))
    libs = variants.build("flash_fwd_stages", {
        "one stage": (os.path.join(_build.CSRC, "flash_fwd.cu"), _build.CSRC),
        "two stages": (two, _build.CSRC)})
    fns = {}
    for name, (lib, _) in libs.items():
        fn = lib.apex_flash_fwd
        fn.argtypes, fn.restype = attn.FLASH_FWD.argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    from apex_tpu_torch.ops import attention as attn
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_stages needs a CUDA card")
    smi = variants.card()
    fns = _build_variants()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(3)
    seed = torch.tensor([99], dtype=torch.int32, device=dev)
    for b, h, s, d in SHAPES:
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        for rate in (0.0, 0.1):
            sd = seed if rate else None
            drop = attn._dropout_args(rate, sd, dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            outs, calls = {}, {}
            for name, fn in fns.items():
                o = torch.empty_like(q)
                lse = torch.empty(b * h, s, device=dev)
                calls[name] = (lambda fn=fn, o=o, lse=lse: fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), None, None, 1, b, h, h, s, s, d, 1,
                    d ** -0.5, *drop, stream))
                if calls[name]() != 0:
                    raise RuntimeError(f"the {name} variant did not launch")
                outs[name] = (o, lse)
            torch.cuda.synchronize()
            (o1, l1), (o2, l2) = outs.values()
            if not (torch.equal(o1, o2) and torch.equal(l1, l2)):
                raise SystemExit(f"({b}, {h}, {s}, {d}) rate {rate}: the "
                                 "variants' bits differ")
            wo, wl = attn.flash_fwd_ref(q, k, v, True, None, None, rate, sd)
            torch.testing.assert_close(o1, wo, atol=2e-2, rtol=2e-2)
            torch.testing.assert_close(l1, wl, atol=1e-4, rtol=1e-5)
            ms = {name: [] for name in fns}
            for name in ("one stage", "two stages", "two stages",
                         "one stage"):
                ms[name].append(variants.device_ms(calls[name]))
            print(f"flash forward ({b}, {h}, {s}, {d}) bf16 causal dropout "
                  f"{rate}: " + "; ".join(
                      f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                      for n, ts in ms.items())
                  + f" (the same bits) [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
