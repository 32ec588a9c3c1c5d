"""Import hygiene of the port: nothing under ``src/repro_torch/`` and
nothing in ``chip_smoke.py`` imports JAX or the JAX package ``repro``."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_sees_the_whole_port():
    assert len(FILES) > 20 and ROOT / "chip_smoke.py" in FILES
    assert _forbidden("repro.core") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.core")


@pytest.mark.parametrize("module", ["core/faults.py", "core/scheduler.py", "serving/loop.py"])
def test_checker_sees_the_async_runtime(module):
    """The asynchronous runtime's modules are the port's own copies: the
    checker above covers them, and they import neither jax nor repro."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


@pytest.mark.parametrize("module", ["core/store.py", "analysis/__init__.py",
                                    "analysis/__main__.py", "analysis/check.py",
                                    "analysis/locklint.py"])
def test_checker_sees_the_store_and_the_verifier(module):
    """The store and the verifier are the port's own copies (the lock lint
    too, though the reference's is stdlib-only): the checker above covers
    them, and they import neither jax nor repro."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]


@pytest.mark.parametrize("module", ["core/fleet.py", "core/__init__.py",
                                    "serving/engine.py", "launch/serve.py"])
def test_checker_sees_the_fleet(module):
    """The fleet overlay and what serves through it are the port's own
    copies: the checker above covers them, and they import neither jax nor
    repro."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    if module == "core/fleet.py":
        import repro_torch.core.fleet as fleet

        assert {"FleetOverlay", "FleetJitAssembled", "FleetStats"} <= set(fleet.__all__)



@pytest.mark.parametrize("module", ["configs/gemma2_27b.py", "configs/minicpm_2b.py",
                                    "configs/mistral_large_123b.py", "configs/archs.py",
                                    "models/layers.py", "models/transformer.py",
                                    "models/model.py", "models/params.py",
                                    "core/graph.py", "core/overlay.py"])
def test_checker_sees_the_dense_family_and_the_frontend(module):
    """The dense family's configs and the modules that serve it, and the
    module-level frontend, are the port's own copies: the checker above
    covers them, and they import neither jax nor repro."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    if module == "core/overlay.py":
        import repro_torch.core as core

        assert {"default_overlay", "jit", "jit_assemble", "Instruction",
                "cache_key"} <= set(core.__all__)


@pytest.mark.parametrize("module", ["configs/zamba2_7b.py", "configs/base.py",
                                    "launch/serve.py"])
def test_checker_sees_the_hybrid(module):
    """zamba2-7b's config and the modules that serve it are the port's own
    copies: the checker above covers them, and they import neither jax nor
    repro."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    if module == "configs/zamba2_7b.py":
        from repro_torch.configs import list_archs

        assert "zamba2-7b" in list_archs()


@pytest.mark.parametrize("module", ["configs/granite_moe_1b.py", "models/moe.py"])
def test_checker_sees_the_moe_family(module):
    """granite-moe-1b-a400m's config and the mixture-of-experts FFN are the
    port's own copies: the checker above covers them, and they import
    neither jax nor repro."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    if module == "configs/granite_moe_1b.py":
        from repro_torch.configs import list_archs

        assert "granite-moe-1b-a400m" in list_archs()


@pytest.mark.parametrize("module", ["configs/deepseek_v3_671b.py", "models/layers.py"])
def test_checker_sees_the_mla_family(module):
    """deepseek-v3-671b's config and the Multi-head Latent Attention layer
    are the port's own copies: the checker above covers them, and they
    import neither jax nor repro."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    if module == "configs/deepseek_v3_671b.py":
        from repro_torch.configs import list_archs

        assert "deepseek-v3-671b" in list_archs()


@pytest.mark.parametrize("module", ["configs/seamless_m4t_medium.py", "data/pipeline.py"])
def test_checker_sees_the_encoder_decoder(module):
    """seamless-m4t-medium's config and the audio stub's batch are the
    port's own copies: the checker above covers them, and they import
    neither jax nor repro."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    if module == "configs/seamless_m4t_medium.py":
        from repro_torch.configs import list_archs

        assert "seamless-m4t-medium" in list_archs()


@pytest.mark.parametrize("module", ["configs/pixtral_12b.py", "models/transformer.py"])
def test_checker_sees_the_vlm(module):
    """pixtral-12b's config and the vision stub's forward are the port's
    own copies: the checker above covers them, and they import neither jax
    nor repro."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    if module == "configs/pixtral_12b.py":
        from repro_torch.configs import list_archs

        assert "pixtral-12b" in list_archs()
