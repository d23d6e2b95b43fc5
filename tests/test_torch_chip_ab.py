"""chip_ab.py, the on-card A/B of the RMSNorm, CE and fp32 flash
forward, dq and dkv kernels' design choices, and of the bf16 flash
forward's, dq's and dkv's on the FMA route: every variant is a rewrite
of the committed source that still applies, so the script builds what
its docstring names."""
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


def test_flash_variants_swap_the_fp32_forward_designs():
    """The forward's copies: the parent's one-tile fwd_kernel takes the
    fp32 forward (fwd_fp32_kernel is never launched) while dq and dkv keep
    their register-blocked kernels; P moves into the consumed K stage
    behind a third barrier, its own buffer leaving the shared memory; two
    blocks an SM at DP = 64; the bias read after the products, from
    four strides at every key, as fwd_kernel reads it; the grid's own
    order of q tiles;
    the 3xTF32 copy replaces fwd_fp32_kernel alone, under its name, with
    mma.sync TF32 products, leaving dq and dkv on FFMA."""
    ab = _chip_ab()
    sources = ab.variant_sources(("flash_attention",))
    committed = sources[("flash_attention", "committed")]
    parent = sources[("flash_attention", ab.FA_FWD_PARENT)]
    assert "if constexpr (kRing<T, DP> && false) {" in parent
    assert ("constexpr bool kRing = std::is_same<T, float>::value && "
            "DP <= 128;") in parent
    p_in_k = sources[("flash_attention", "forward, P in the consumed K stage")]
    assert "float* Ps = Ks + (kt & 1) * KT;" in p_in_k
    assert committed.count("__syncthreads()") + 1 == p_in_k.count(
        "__syncthreads()")
    assert "+ 64 * (64 + 4));" in committed and "+ 64 * (64 + 4));" not in \
        p_in_k
    assert "__launch_bounds__(kThreads)\nfwd_fp32_kernel" in committed
    two = sources[("flash_attention", "forward at two blocks an SM")]
    assert "__launch_bounds__(kThreads, DP == 64 ? 2 : 1)\nfwd_fp32_kernel" \
        in two
    late = sources[("flash_attention", "forward, bias read after the products")]
    body = late.split("fwd_fp32_kernel(")[1]
    assert "biased(s[i][j], scale, mk, dm, b, h, r, c)" in body
    assert "fmul_rn(s[i][j], scale), bv[i][j])" not in body
    order = sources[("flash_attention", "forward in the grid's own order")]
    assert "const int bh = blockIdx.y;" in order.split("fwd_fp32_kernel(")[1]
    tc = sources[("flash_attention", ab.FA_FWD_TENSOR_CORES)]
    mma = "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"
    assert mma not in committed and tc.count(mma) == 1
    for kernel in ("fwd_fp32_kernel(", "dq_fp32_kernel(", "dkv_fp32_kernel("):
        assert committed.count(kernel) == tc.count(kernel) == 1
    assert tc.count("score_product<") == committed.count(
        "score_product<") - 1
    assert "score_products<" in tc and "second_product<" in tc


def test_tile_chain_model_of_the_fp32_forward_grid():
    """The model behind PERF.md's causal-chain figures: at one block an SM
    the GPT-2 oracle's forward (192 q tiles) takes its longest q tile's
    16 key tiles where the work spread evenly is 12.36 an SM, the Llama
    oracle's 17 against 16.48, BERT's two waves of 8 tiles 16; the grid's
    own order takes 22 and 27."""
    ab = _chip_ab()
    got = {label: (ab.tile_chain_units(b, s, h, causal),
                   ab.tile_chain_units(b, s, h, causal, longest_first=False))
           for label, (b, s, h, _, causal, _) in ab.FLASH_SHAPES.items()}
    (gpt2, gpt2_grid), (llama, llama_grid), (bert, bert_grid) = (
        got["GPT-2 oracle"], got["Llama oracle"], got["BERT oracle"])
    assert gpt2[0] == 16 and round(gpt2[1], 2) == 12.36 and gpt2_grid[0] == 22
    assert llama[0] == 17 and round(llama[1], 2) == 16.48 and \
        llama_grid[0] == 27
    assert bert[0] == bert_grid[0] == 16 and round(bert[1], 2) == 15.52


def test_section_rewrite_replaces_from_start_to_end():
    ab = _chip_ab()
    assert ab._edit("a [x] b", ("[", "]"), "<y>") == "a <y>] b"
    with pytest.raises(ValueError, match="no longer holds"):
        ab._edit("a [x] [b]", ("[", "x"), "")


def test_flash_variants_swap_the_bf16_forward_designs():
    """The bf16 forward's copies: the parent's one-tile fwd_kernel takes
    the bf16 forward (fwd_mma_kernel is never launched); the others change
    one tile constant of ``MmaTile``, the S loop's unrolling or when O is
    rescaled, and leave the fp32 kernels' text alone."""
    ab = _chip_ab()
    sources = ab.variant_sources(("flash_attention",))
    committed = sources[("flash_attention", "committed")]
    assert "fwd_mma_kernel<DP, MASK><<<" in committed
    parent = sources[("flash_attention", ab.FA_BF16_PARENT)]
    assert "constexpr bool kMma = false;" in parent
    fp32 = committed[:committed.index("// bf16 forward on the tensor cores")]
    for name in ab.BF16_FWD_VARIANTS:
        text = sources[("flash_attention", name)]
        assert text.startswith(fp32) and text != committed, name
    both = sources[("flash_attention",
                    "bf16 forward, 4 warps and 32-key tiles at DP = 256")]
    assert "static constexpr int WARPS = 4;" in both
    assert "BK = DP == 256 ? 32 : 64;" in both


def test_flash_variants_swap_the_bf16_backward_designs():
    """The bf16 dq and dkv copies: the parent's one-tile dq_kernel /
    dkv_kernel take bf16 dq and dkv (a routing edit: dq_mma_kernel and
    dkv_mma_kernel are never launched); the others change one tile
    constant of ``DqTile`` / ``DkvTile`` or the launch bounds, and leave
    the text before the backward's section alone. ``--flash-parts``
    builds each part's copies alone: the parts cover every copy, each
    with the committed one."""
    ab = _chip_ab()
    sources = ab.variant_sources(("flash_attention",))
    committed = sources[("flash_attention", "committed")]
    for kernel in ("dq_mma_kernel<DP, MASK><<<",
                   "dkv_mma_kernel<DP, MASK><<<"):
        assert kernel in committed
    parent = sources[("flash_attention", ab.FA_BF16_BWD_PARENT)]
    assert "constexpr bool kMmaBwd = false;" in parent
    assert "constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;" \
        in parent
    head = committed[:committed.index(
        "// bf16 dq and dkv on the tensor cores")]
    for name in ab.BF16_BWD_VARIANTS:
        text = sources[("flash_attention", name)]
        assert text.startswith(head) and text != committed, name
    split = sources[("flash_attention", "bf16 dkv, D split at DP = 128")]
    assert "static constexpr int NS = DP >= 128 ? 2 : 1;" in split
    assert set().union(*ab.FLASH_PARTS.values()) == set(ab.FLASH_VARIANTS)
    assert all("committed" in part for part in ab.FLASH_PARTS.values())
    only = ab.variant_sources(("flash_attention", "rms_norm"), {
        "flash_attention": ab.FLASH_PARTS["bf16_bwd"]})
    assert {v for (n, v) in only if n == "flash_attention"} == set(
        ab.FLASH_PARTS["bf16_bwd"])
    assert {v for (n, v) in only if n == "rms_norm"} == set(ab.RMS_VARIANTS)
