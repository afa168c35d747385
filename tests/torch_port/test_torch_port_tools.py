"""apex_tpu_torch.tools.variants: the source variants that the flash
timing tools build beside the shipped kernels.

A variant sets constants of one geometry struct anew.  These tests hold
``override`` to its contract on a small source (the one definition in
the named struct changes, nothing else does; a constant the struct only
inherits is defined at the top of its body; a missing struct or a
constant defined twice raises), and apply every variant of every tool
to this tree's ``csrc`` sources, so an edit that drops a constant a
variant needs fails here rather than on the card.  Building and timing
need ``nvcc`` and a card.
"""

import re

import pytest

from apex_tpu_torch.tools import (flash_fwd_stages, flash_narrow_tc,
                                  flash_wide_f32, variants)

SRC = """\
struct Base {
  static constexpr int TILE = 64;
};

template <int W_>
struct Geo : Base {
  static constexpr int W = W_;                  // columns
  static constexpr int CTAS = W == 32 ? 2 :
                              3;
  static constexpr bool DIRECT = W < 256;       // whole scores
};

struct GeoWide {
  static constexpr int CTAS = 1;
};
"""


def test_override_replaces_the_one_definition_in_its_struct():
    out = variants.override(SRC, "Geo", "CTAS", "W < 64 ? 1 : 2")
    assert "  static constexpr int CTAS = W < 64 ? 1 : 2;\n" in out
    assert "W == 32 ? 2" not in out
    assert "struct GeoWide {\n  static constexpr int CTAS = 1;" in out
    assert out.replace("W < 64 ? 1 : 2", "") == SRC.replace(
        "W == 32 ? 2 :\n                              3", "")
    flag = variants.override(SRC, "Geo", "DIRECT", "false")
    assert "static constexpr bool DIRECT = false;       // whole scores" \
        in flag


def test_override_defines_an_inherited_constant_at_the_top():
    out = variants.override(SRC, "Geo", "TILE", "W_ < 64 ? 128 : Base::TILE")
    head = "struct Geo : Base {\n  static constexpr int TILE = " \
           "W_ < 64 ? 128 : Base::TILE;\n  static constexpr int W = W_;"
    assert head in out
    assert "struct Base {\n  static constexpr int TILE = 64;" in out


@pytest.mark.parametrize("struct, name, error", [
    ("Missing", "CTAS", "no struct Missing"),
    ("Ge", "CTAS", "no struct Ge"),
    ("Dup", "X", "defines X 2 times"),
])
def test_override_raises(struct, name, error):
    src = SRC + "struct Dup {\n  static constexpr int X = 1;\n" \
                "  static constexpr int X = 2;\n};\n"
    with pytest.raises(ValueError, match=error):
        variants.override(src, struct, name, "0")


def _tool_variants():
    for name, changes in flash_wide_f32.VARIANTS.items():
        yield f"flash_wide_f32 {name}", "flash_bwd", changes
    for name, (lib, struct, const, expr) in flash_narrow_tc.VARIANTS.items():
        yield f"flash_narrow_tc {name}", lib, [(struct, const, expr)]
    yield "flash_fwd_stages two stages", "flash_fwd", \
        flash_fwd_stages.TWO_STAGES


@pytest.mark.parametrize("lib, changes", [
    pytest.param(lib, changes, id=name)
    for name, lib, changes in _tool_variants()])
def test_every_tool_variant_applies_to_the_sources(lib, changes):
    from apex_tpu_torch import _build
    with open(f"{_build.CSRC}/{lib}.cu") as f:
        shipped = f.read()
    out = variants.variant(lib, changes)
    assert out != shipped or all(
        re.search(rf"static constexpr \w+ {c} = {re.escape(e)};", shipped)
        for _, c, e in changes)
    for struct, const, expr in changes:
        head = re.search(rf"^struct {struct}\b[^{{;]*\{{", out, re.M)
        body = out[head.end():out.index("\n};\n", head.end())]
        assert re.findall(rf"static constexpr \w+ {const} =[^;]*;", body) \
            == [f"static constexpr int {const} = {expr};"]
