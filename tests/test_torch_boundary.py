"""The port's boundaries: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and the port's entry points refuse to
run on a machine without a card unless the caller names the CPU."""
from __future__ import annotations

import ast
import pathlib

import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch

from repro_torch.configs.smoke import smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import Engine, ServeConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value.split(".")[0]


def test_port_files_exist():
    assert len(PORT_FILES) > 30 and all(p.is_file() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    roots = set(_imported_roots(path))
    assert "jax" not in roots and "jaxlib" not in roots, path
    assert "repro" not in roots, path          # repro_torch is fine


def test_import_walk_sees_what_it_must_refuse(tmp_path):
    """The walk itself catches every spelling it is asked to refuse."""
    src = ("import jax.numpy as jnp\nfrom repro.serve import Engine\n"
           "import importlib\nimportlib.import_module('repro.models')\n"
           "from repro_torch import configs\n")
    tmp = tmp_path / "probe.py"
    tmp.write_text(src)
    assert set(_imported_roots(tmp)) == {"jax", "repro", "importlib",
                                         "repro_torch"}


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_without_device_raises_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    model = build_model(smoke_config("granite-8b", num_layers=2))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, params, ServeConfig())
    Engine(model, params, ServeConfig(), device="cpu")       # named: fine


def test_model_init_and_caches_default_to_the_card(monkeypatch):
    _no_card(monkeypatch)
    model = build_model(smoke_config("granite-8b", num_layers=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_decode_caches(2, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_launcher_without_device_raises_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_launcher.main(["--arch", "granite-8b", "--smoke"])


def test_engine_refuses_params_on_another_device():
    model = build_model(smoke_config("granite-8b", num_layers=2))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    params = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError, match="params live on"):
        Engine(model, params, ServeConfig(), device="cpu")
