"""The BERT example's default model on the card, step by step: the
proxy (4 x h128, heads of 32, vocab 2048), amp O2 and FusedLAMB on the
unmasked 8 x 512 batch, as ``examples/bert_pretrain_mlm.py``'s
``train()`` runs it with no flags::

    python -m apex_tpu_torch.tools.bert_proxy_step [--other DIR]

After 2 warm-up steps it reports the host's pace (CUDA events between 4
steps run as ``train()`` runs them: the host leads this small model, so
this is not device time), the device milliseconds a step (4 steps queued
behind a device spin that outlasts the host's launching them, CUDA
events around them; "not measured" where a step waited on the host),
and one profiled step's busy device milliseconds with the three flash
kernels' milliseconds and device names.  ``--other DIR``: the same,
each measurement in its own process, for this checkout and for the
package of another checkout (DIR holds its ``apex_tpu_torch``, for
instance an unpacked ``git archive`` of an earlier commit) in turns:
this, other, other, this; with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

FLASH = {"flash_fwd": "flash_fwd_kernel", "flash_dq": "flash_dq_kernel",
         "flash_dkv": "flash_dkv_kernel"}
STEPS = 4


def _spin_cycles_per_ms() -> float:
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(20_000_000)
    b.record()
    b.synchronize()
    return 20_000_000 / a.elapsed_time(b)


def _device_ms(fn, iters: int):
    """Device ms a call of ``fn``: ``iters`` calls queued behind a spin
    that outlasts their launching (tried with longer spins three times);
    None where the device went idle first (a call waited on the host)."""
    import torch
    per_ms = _spin_cycles_per_ms()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        torch.cuda._sleep(int((2.0 * host_ms + 1.0) * per_ms))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        hidden = not start.query()          # the device still spins
        end.synchronize()
        if hidden:
            return start.elapsed_time(end) / iters
        host_ms *= 4.0
    return None


def _profiled(fn, layers: int) -> tuple:
    """One call of ``fn`` under ``torch.profiler``, after 64 small kernels
    and a spin (a session can lose its first records), read again (up to
    3 sessions) until every flash kernel shows ``layers`` records:
    (busy device ms, {kernel: (ms, {device name: count})})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    per_ms = _spin_cycles_per_ms()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            x = torch.zeros(1024, device="cuda")
            for _ in range(64):
                x.add_(1.0)
            torch.cuda._sleep(int(20 * per_ms))
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        spins = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        events = events[spins[-1] + 1:] if spins else events
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
        flash = {}
        for kn, sym in FLASH.items():
            names = {}
            for e in events:
                if sym in e.name:
                    names[e.name] = names.get(e.name, 0) + 1
            ms = sum(e.time_range.elapsed_us() for e in events
                     if sym in e.name) / 1e3
            flash[kn] = (ms, names)
        if all(sum(n.values()) == layers for _, n in flash.values()):
            break
    return busy, flash


def measure(dev) -> dict:
    """The proxy's step on ``dev`` (a CUDA device), from seed 0."""
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.examples import bert_pretrain_mlm as pretrain
    _build.build_all({k.library for k in _build.KERNELS})
    torch.backends.cuda.matmul.allow_tf32 = False
    model = pretrain.model_for(False, 512, "O2")
    _, state, step = pretrain.setup(model, model.init(0, "cpu"), dev,
                                    opt_level="O2")
    inputs, real, _ = pretrain.synthetic_batch(model.vocab_size, 8, 512,
                                               False, dev)
    for _ in range(2):
        _, state = step(state, **inputs)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(STEPS + 1)]
    events[0].record()
    for i in range(STEPS):
        _, state = step(state, **inputs)
        events[i + 1].record()
    torch.cuda.synchronize()
    pace = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    device = _device_ms(lambda: step(state, **inputs), STEPS)
    busy, flash = _profiled(lambda: step(state, **inputs), model.num_layers)
    return dict(pace_ms=pace, device_ms=device, busy_ms=busy, flash=flash,
                layers=model.num_layers, tokens=real)


def _line(tag: str, r: dict) -> str:
    dev = ("not measured" if r["device_ms"] is None
           else f"{r['device_ms']:.3f}")
    pace = sorted(r["pace_ms"])
    return (f"bert proxy step {tag}: device ms a step {dev} (behind a "
            f"spin); host pace {pace[len(pace) // 2]:.3f} ms a step (CUDA "
            f"events, median of {len(pace)}); busy {r['busy_ms']:.3f} ms in "
            "a profiled step, flash " + ", ".join(
                f"{kn} {ms:.3f} ms ({', '.join(f'{n} x{c}' for n, c in names.items())})"
                for kn, (ms, names) in r["flash"].items()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", default=None)
    p.add_argument("--json", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bert_proxy_step needs a CUDA card")
    if args.json or args.other is None:
        r = measure(torch.device("cuda"))
        print(json.dumps(r) if args.json else _line("this", r), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    roots = {"this": here, "other": os.path.abspath(args.other)}
    runs = {"this": [], "other": []}
    for tag in ("this", "other", "other", "this"):
        env = dict(os.environ, PYTHONPATH=roots[tag])
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--json"], cwd=roots[tag], env=env,
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise SystemExit(f"the {tag} run failed:\n{out.stderr[-3000:]}")
        r = json.loads(out.stdout.strip().splitlines()[-1])
        runs[tag].append(r)
        print(_line(tag, r) + f" [{smi}]", flush=True)
    for tag, rs in runs.items():
        dev = [r["device_ms"] for r in rs]
        print(f"bert proxy step {tag} ({roots[tag]}): device ms a step "
              + " / ".join("not measured" if d is None else f"{d:.3f}"
                           for d in dev)
              + ", busy " + " / ".join(f"{r['busy_ms']:.3f}" for r in rs)
              + ", flash " + " / ".join(
                  f"{sum(ms for ms, _ in r['flash'].values()):.3f}"
                  for r in rs) + f" ms [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
