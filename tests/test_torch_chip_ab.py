"""chip_ab.py, the on-card A/B of the RMSNorm, CE and fp32 flash dq /
dkv kernels' design choices: every variant is a rewrite of the committed
source that still applies, so the script builds what its docstring
names."""
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_ab():
    spec = importlib.util.spec_from_file_location(
        "chip_ab", os.path.join(REPO, "chip_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_variant_rewrites_the_committed_source():
    ab = _chip_ab()
    sources = ab.variant_sources()
    assert set(sources) == (
        {("rms_norm", v) for v in ab.RMS_VARIANTS}
        | {("cross_entropy", v) for v in ab.CE_VARIANTS}
        | {("flash_attention", v) for v in ab.FLASH_VARIANTS})
    for (name, variant), text in sources.items():
        with open(os.path.join(ab.CSRC, f"{name}.cu")) as f:
            base = f.read()
        assert (text == base) == (variant == "committed"), (name, variant)
    assert len(set(sources.values())) == len(sources)


def test_a_stale_rewrite_raises():
    ab = _chip_ab()
    with pytest.raises(ValueError, match="no longer holds"):
        ab._edit("int a = 1;", "int b = 2;", "int b = 3;")


def test_flash_variants_swap_the_fp32_dq_and_dkv_designs():
    """The flash copies: the one-tile FFMA kernels take fp32 dq and
    dkv (the register-blocked kernels are never launched); the 3xTF32
    copy replaces both register-blocked kernels, under their names, with
    mma.sync TF32 products of split operands, and sizes their shared
    memory; the others change one launch bound or tile height. One
    source's copies alone build with ``names``."""
    ab = _chip_ab()
    sources = ab.variant_sources(("flash_attention",))
    assert set(sources) == {("flash_attention", v) for v in ab.FLASH_VARIANTS}
    one_tile = sources[("flash_attention", "one-tile FFMA kernels")]
    assert "constexpr bool kRing = false;" in one_tile
    tc = sources[("flash_attention", ab.FA_TENSOR_CORES)]
    committed = sources[("flash_attention", "committed")]
    mma = "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"
    assert mma not in committed and tc.count(mma) == 1
    assert "cvt.rna.tf32.f32" in tc
    for kernel in ("dq_fp32_kernel(", "dkv_fp32_kernel("):
        assert committed.count(kernel) == tc.count(kernel) == 1
    assert "score_products<" in committed and "score_products<" not in tc
    assert "(6 * 64 * DP + (pass == Pass::kDq ? 2 : 4) * 64)" in tc


def test_section_rewrite_replaces_from_start_to_end():
    ab = _chip_ab()
    assert ab._edit("a [x] b", ("[", "]"), "<y>") == "a <y>] b"
    with pytest.raises(ValueError, match="no longer holds"):
        ab._edit("a [x] [b]", ("[", "x"), "")
