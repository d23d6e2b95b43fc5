"""PyTorch port: paddle_tpu_torch, chip_smoke.py and chip_ab.py never
import jax or paddle_tpu (only the tests import both), and every entry
point defaults to the cuda device."""
import ast
import inspect
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chip_ab.py")


def _module_name(path: str) -> str:
    rel = os.path.relpath(path, REPO)[:-3].split(os.sep)
    if rel[-1] == "__init__":
        rel = rel[:-1]
    return ".".join(rel)


def test_ast_scan_finds_no_forbidden_import():
    bad = []
    for path in _py_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        mod = _module_name(path)
        pkg = mod if path.endswith("__init__.py") else mod.rpartition(".")[0]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    # relative: resolve, and it must stay in the package
                    base = pkg.split(".")
                    base = base[:len(base) - (node.level - 1)]
                    names = [".".join(base + ([node.module]
                                              if node.module else []))]
                    if not names[0].startswith("paddle_tpu_torch"):
                        bad.append(f"{path}:{node.lineno} leaves the "
                                   f"package: {names[0]}")
                else:
                    names = [node.module]
            else:
                continue
            bad += [f"{path}:{node.lineno} imports {n}" for n in names
                    if _forbidden(n)]
    assert bad == []


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "before = set(sys.modules)\n"
        "import paddle_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "paddle_tpu_torch.__path__, 'paddle_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "bad = [m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu')]\n"
        "need = ['paddle_tpu_torch.core.flags', "
        "'paddle_tpu_torch.ops.kernels.cross_entropy', "
        "'paddle_tpu_torch.io.prefetch', 'paddle_tpu_torch.optimizer.lr', "
        "'paddle_tpu_torch.nn.clip']\n"
        "assert not set(need) - set(names), sorted(set(need) - set(names))\n"
        "print(len(names), bad)\n"
        "assert 'jax' not in sys.modules and 'paddle_tpu' not in "
        "sys.modules, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 20 and bad.strip() == "[]"


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke test exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_default_to_cuda():
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.core.random import make_generator
    from paddle_tpu_torch.models import GPTForCausalLM, LlamaForCausalLM
    from paddle_tpu_torch.models.decode import init_contiguous_cache
    from paddle_tpu_torch.nn.layer import (Embedding, LayerNorm, Linear,
                                           MultiHeadAttention, RMSNorm,
                                           TransformerEncoderLayer)
    from paddle_tpu_torch.serving.decode import DecodeServer, PagedKV
    from paddle_tpu_torch.serving.decode.kvcache import init_paged_cache
    assert resolve_device(None) == torch.device("cuda")
    for fn in (make_generator, LlamaForCausalLM, GPTForCausalLM,
               init_contiguous_cache, Embedding, Linear, RMSNorm, LayerNorm,
               MultiHeadAttention, TransformerEncoderLayer, DecodeServer,
               PagedKV, init_paged_cache):
        p = inspect.signature(fn).parameters["device"]
        assert p.default is None, fn       # None resolves to cuda
