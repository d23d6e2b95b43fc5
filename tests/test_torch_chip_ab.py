"""chip_ab.py, the on-card A/B of the RMSNorm and CE kernels' design
choices: every variant is a rewrite of the committed source that still
applies, so the script builds what its docstring names."""
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
        | {("cross_entropy", v) for v in ab.CE_VARIANTS})
    for (name, variant), text in sources.items():
        with open(os.path.join(ab.CSRC, f"{name}.cu")) as f:
            base = f.read()
        assert (text == base) == (variant == "committed"), (name, variant)
    assert len(set(sources.values())) == len(sources)


def test_a_stale_rewrite_raises():
    ab = _chip_ab()
    with pytest.raises(ValueError, match="no longer holds"):
        ab._edit("int a = 1;", "int b = 2;", "int b = 3;")
