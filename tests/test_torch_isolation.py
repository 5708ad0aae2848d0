"""The port stands alone: an AST scan of ``src/repro_torch`` (every
subpackage: the solver, the models, the training modules ``optim``,
``data``, ``checkpoint`` and ``launch/train.py``, ``examples``, the dry run
and the roofline: ``roofline/``, ``dist/sharding.py``,
``dist/act_sharding.py``, ``launch/{mesh,specs,dryrun}.py``) and
``chip_smoke.py``.

* No ``import jax``/``from jax ...`` and no import of the JAX package
  ``repro`` or any ``repro.*`` module (``repro_torch`` itself is allowed),
  absolute or relative, at any depth.
* No ``try`` that catches a kernel-launch failure and falls back: a ``try``
  whose body reaches a kernel wrapper, a launch binding or the kernel build
  must re-raise from every handler.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]

#: names whose call reaches a Hopper kernel launch or its build
KERNEL_CALLS = {"compress", "decompress", "matvec", "rmatvec", "compress_2d",
                "decompress_2d", "matvec_2d", "rmatvec_2d", "build_all",
                "library", "bind", "write_row", "read_row", "read_all", "dots",
                "combine", "gmres", "cb_gmres", "ell_spmv", "ell_spmv_2d",
                "ell_spmv_frsz2_2d", "givens_step", "operand", "replay",
                "CUDAGraph", "graph", "_capture", "_replay", "_run",
                "block_dots", "block_combine", "block_dots_2d",
                "block_combine_2d", "block_givens_step", "write_block",
                "read_block", "read_all_blocks", "gmres_batched",
                "gmres_block", "decode_attention", "decode_attn", "attend",
                "append", "build_cache", "encode_heads", "decode_heads",
                "decode_step", "prefill", "serve", "adamw_init",
                "adamw_update", "_compress_leaf", "_decompress_leaf",
                "make_step", "step_fn", "train", "profile_train"}


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                assert not _banned(alias.name), (path, node.lineno, alias.name)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0 or not (node.module or "").startswith(
                "repro."), (path, node.lineno)
            if node.level == 0:
                assert not _banned(node.module or ""), (path, node.lineno,
                                                        node.module)
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                assert not (isinstance(arg, ast.Constant)
                            and _banned(str(arg.value))), (path, node.lineno)


def _calls(nodes):
    for node in nodes:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                f = sub.func
                yield f.attr if isinstance(f, ast.Attribute) else getattr(
                    f, "id", "")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_try_falls_back_from_a_kernel(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        if not KERNEL_CALLS.intersection(_calls(node.body)):
            continue
        for handler in node.handlers:
            reraises = any(isinstance(s, ast.Raise)
                           for s in ast.walk(ast.Module(handler.body, [])))
            assert reraises, (f"{path}:{handler.lineno}: a handler swallows "
                              "a failure of a kernel path")


def test_scan_sees_the_package():
    names = {p.name for p in FILES}
    assert {"ops.py", "gmres.py", "accessor.py", "chip_smoke.py",
            "ell_spmv.py", "gmres_step.py", "csr.py", "block.py",
            "frsz2_block.py", "decode_attn.py", "kvcache.py", "lm.py",
            "serve.py", "registry.py", "adamw.py", "pipeline.py", "store.py",
            "train.py", "train_lm.py", "serve_decode.py", "tree.py"} <= names
    # every subpackage of the port, the training ones included
    subs = {p.parent.name for p in FILES}
    assert {"optim", "data", "checkpoint", "examples", "models", "kernels",
            "launch"} <= subs


#: the dry run's and the roofline's modules (their scans run above)
DRYRUN_MODULES = ["roofline/__init__.py", "roofline/__main__.py",
                  "roofline/analysis.py", "roofline/analytic.py",
                  "roofline/probe.py", "roofline/table.py",
                  "dist/sharding.py", "dist/act_sharding.py",
                  "launch/mesh.py", "launch/specs.py", "launch/dryrun.py"]


@pytest.mark.parametrize("rel", DRYRUN_MODULES)
def test_scan_covers_the_dry_run(rel):
    path = ROOT / "src" / "repro_torch" / rel
    assert path.is_file()
    assert path in FILES
