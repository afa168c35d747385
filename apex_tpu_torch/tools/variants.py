"""What the port's flash timing tools (``flash_fwd_stages``,
``flash_narrow_tc``, ``flash_wide_f32``) share: a ``csrc`` source with
design constants of one geometry struct changed, every source built at
once beside the port's own libraries, and a call's device time.

A variant names a constant and its new expression, not a source line::

    override(text, "DqWide", "CTAS", "W < 64 ? 2 : 228 * 1024 / (SMEM + 1024)")

replaces the one ``static constexpr int CTAS = ...;`` inside ``struct
DqWide``'s body (a struct that only inherits the constant gets a
definition at the top of its body), so an edit to any other line leaves
the variant as it was, and an edit that removes the constant raises.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess

_DEF = r"static constexpr (int|bool) {name} =[^;]*;"


def override(text: str, struct: str, name: str, expr: str) -> str:
    """``text`` with ``struct``'s constant ``name`` set to ``expr``."""
    head = re.search(rf"^struct {re.escape(struct)}\b[^{{;]*\{{", text, re.M)
    if head is None:
        raise ValueError(f"no struct {struct}")
    end = text.index("\n};\n", head.end())
    body = text[head.end():end]
    defs = list(re.finditer(_DEF.format(name=re.escape(name)), body))
    if len(defs) > 1:
        raise ValueError(f"struct {struct} defines {name} {len(defs)} times")
    if defs:
        d = defs[0]
        body = (body[:d.start()] + f"static constexpr {d.group(1)} {name} = "
                f"{expr};" + body[d.end():])
    else:
        body = f"\n  static constexpr int {name} = {expr};" + body
    return text[:head.end()] + body + text[end:]


def variant(lib: str, changes) -> str:
    """``csrc/<lib>.cu``'s text with each ``(struct, constant, expression)``
    of ``changes`` applied."""
    from apex_tpu_torch import _build
    with open(os.path.join(_build.CSRC, f"{lib}.cu")) as f:
        text = f.read()
    for struct, name, expr in changes:
        text = override(text, struct, name, expr)
    return text


def _slug(name: str) -> str:
    return re.sub(r"\W+", "_", name).strip("_")


def write(prefix: str, name: str, text: str) -> str:
    """Writes a variant's text beside the port's libraries; returns its
    path."""
    from apex_tpu_torch import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, f"{prefix}_{_slug(name)}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build(prefix: str, sources: dict) -> dict:
    """{name: (library, nvcc's report)} for each ``{name: (a .cu's path,
    its include directory)}``, all compiled at once with the port's nvcc
    flags into the port's build directory; a failed build raises."""
    from apex_tpu_torch import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, (src, include) in sources.items():
        so = os.path.join(_build.BUILD_DIR, f"{prefix}_{_slug(name)}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", include, "-o", so,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = (ctypes.CDLL(so), log)
    return out


def ptxas_lines(log: str, entry_pattern: str):
    """(kernel, registers, spills) of each kernel whose mangled name
    matches ``entry_pattern`` in nvcc's ``-Xptxas -v`` report."""
    out, entry, spill = [], None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], None
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry \
                and re.search(entry_pattern, entry):
            out.append((entry, line.split(":", 1)[-1].strip(), spill))
    return out


def device_ms(call, iters: int = 50, warm: int = 3) -> float:
    """Device milliseconds a call: CUDA events around ``iters`` calls
    queued behind a device spin, so the host's launching is hidden."""
    import torch
    for _ in range(warm):
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


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
