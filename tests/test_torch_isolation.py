"""The port stands alone: no module under ``src/repro_torch/`` (nor
``chip_smoke.py`` and the card-side tools) imports ``jax`` or the JAX
package, every module
imports on a machine without ``nvcc``, and the entry points run on the
card unless the caller asks for the CPU."""
import ast
import importlib
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_serve.py",
        REPO / "tools" / "profile_torch_decode.py",
        REPO / "tools" / "flash_ab.py", REPO / "tools" / "verify_ab.py",
        REPO / "tools" / "rollback_ab.py",
        REPO / "tools" / "profiler_windows.py",
        REPO / "tools" / "width_probe.py",
        REPO / "tools" / "predict_ab.py",
        REPO / "tools" / "ssd_order_probe.py",
        REPO / "tools" / "profile_torch_phases.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    assert path.exists(), path
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_lane_sharding_modules_are_checked():
    """The lane-sharding modules are among the files and modules above."""
    mods = _modules()
    for m in ("repro_torch.sharding.specs", "repro_torch.launch.mesh"):
        assert m in mods
        assert PORT / (m.split(".", 1)[1].replace(".", "/") + ".py") \
            in _port_files()


def test_dry_run_modules_are_checked():
    """The dry run's modules are among the files and modules above."""
    mods = _modules()
    for m in ("repro_torch.launch.dryrun", "repro_torch.launch.steps",
              "repro_torch.launch.cost_analysis",
              "repro_torch.launch.dryrun_speca"):
        assert m in mods
        assert PORT / (m.split(".", 1)[1].replace(".", "/") + ".py") \
            in _port_files()


def _import_sets_nothing(module):
    code = ("import os, json\n"
            "before = dict(os.environ)\n"
            f"import {module}\n"
            "import torch.distributed as dist\n"
            "print(json.dumps([dict(os.environ) == before,"
            " dist.is_initialized()]))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[true, false]"


def test_dry_run_import_sets_nothing():
    """Importing the dry run sets no environment variable and starts no
    process group (the reference's sets ``XLA_FLAGS`` at import)."""
    _import_sets_nothing("repro_torch.launch.dryrun")


def test_speca_dry_run_import_sets_nothing():
    """The same of the SpeCa-step dry run (the reference's
    ``dryrun_speca`` sets ``XLA_FLAGS`` at its first line)."""
    _import_sets_nothing("repro_torch.launch.dryrun_speca")


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


@pytest.mark.parametrize("module", _modules())
def test_every_module_imports_without_nvcc(module, monkeypatch):
    """Importing builds nothing: no nvcc, no triton, no CUDA needed."""
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    mod = importlib.import_module(module)
    assert mod is not None


def test_kernel_build_is_lazy(tmp_path):
    """A fresh interpreter with no CUDA toolkit on its path imports every
    module of the port, and nothing is built or loaded."""
    from repro_torch.kernels import build
    assert set(build.SOURCES) == set(build.SIGNATURES)
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        for entry in build.SIGNATURES[name]:
            assert f'extern "C" int {entry}(' in src, (name, entry)
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "from repro_torch.kernels import build\n"
            "assert build._loaded == {} and build.build_logs == {}\n"
            "print('ok')\n")
    env = {"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path),
           "PYTHONPATH": str(REPO / "src"), "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


@pytest.mark.parametrize("entry", ["init_params", "params_from_jax",
                                   "engine", "speca_sample",
                                   "sample_full", "lm_init_params",
                                   "lm_params_from_jax", "decode_workload",
                                   "engine_workloads",
                                   "init_controller_state",
                                   "train_diffusion", "lm_make_train_state",
                                   "cached_sample", "restore_checkpoint",
                                   "params_from_checkpoint", "serve_cli",
                                   "serve_cli_diffusion", "train_cli",
                                   "make_lane_mesh", "serve_cli_mesh"])
def test_entry_points_default_to_cuda(no_gpu, entry, tmp_path):
    from repro_torch import configs as PC
    from repro_torch.convert import params_from_jax
    from repro_torch.core.controller import init_controller_state
    from repro_torch.core.speca import speca_sample
    from repro_torch.core.workload import DecodeWorkload
    from repro_torch.diffusion.pipeline import sample_full
    from repro_torch.layers.model import init_params
    from repro_torch.serving import SpeCaEngine
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.convert import params_from_checkpoint
    from repro_torch.core.baselines import cached_sample, fora
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_lane_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import lm as T
    from repro_torch.training.diffusion_trainer import train_diffusion

    cfg = PC.ModelConfig(name="t", num_layers=1, d_model=8, num_heads=2,
                         d_ff=16, num_classes=2, dtype="float32")
    lm = PC.ModelConfig(name="lm", arch_type="dense", num_layers=1,
                        d_model=8, num_heads=2, num_kv_heads=1, d_ff=16,
                        vocab_size=20, dtype="float32")
    dcfg = PC.DiffusionConfig(num_inference_steps=2, latent_size=4)
    scfg = PC.SpeCaConfig()
    params = init_params(cfg, torch.Generator(), device="cpu")
    lm_params = init_params(lm, torch.Generator(), device="cpu")
    decode = DecodeWorkload(lm, lm_params, scfg, max_new_tokens=2,
                            max_seq_len=8, device="cpu")
    cond = {"labels": torch.tensor([0])}
    calls = {
        "init_params": lambda: init_params(cfg, torch.Generator()),
        "params_from_jax": lambda: params_from_jax(_numpy_tree(params)),
        "engine": lambda: SpeCaEngine(cfg, params, dcfg, scfg),
        "speca_sample": lambda: speca_sample(cfg, params, dcfg, scfg, cond,
                                             1),
        "sample_full": lambda: sample_full(cfg, params, dcfg, cond, 1),
        "lm_init_params": lambda: init_params(lm, torch.Generator()),
        "lm_params_from_jax": lambda: params_from_jax(
            _numpy_tree(lm_params)),
        "decode_workload": lambda: DecodeWorkload(
            lm, lm_params, scfg, max_new_tokens=2, max_seq_len=8),
        "engine_workloads": lambda: SpeCaEngine(
            workloads={"decode": decode}),
        "init_controller_state": lambda: init_controller_state(2, 2),
        "train_diffusion": lambda: train_diffusion(
            cfg, dcfg, PC.TrainConfig(steps=1, global_batch=2),
            verbose=False),
        "lm_make_train_state": lambda: T.make_train_state(
            lm, torch.Generator(), AdamWConfig()),
        "cached_sample": lambda: cached_sample(cfg, params, dcfg, fora(2),
                                               cond, 1),
        "restore_checkpoint": lambda: restore_checkpoint(ck, params),
        "params_from_checkpoint": lambda: params_from_checkpoint(ck),
        "serve_cli": lambda: serve_cli.main(["--mode", "lm", "--arch",
                                             "mamba2-130m"]),
        "serve_cli_diffusion": lambda: serve_cli.main(["--requests", "1"]),
        "train_cli": lambda: train_cli.main(["--arch", "mamba2-130m",
                                             "--reduced", "--steps", "1"]),
        "make_lane_mesh": lambda: make_lane_mesh(2),
        "serve_cli_mesh": lambda: serve_cli.main(["--mesh", "2"]),
    }
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_cuda_tensor_never_takes_the_plain_path():
    """With no card, a CUDA-typed call must raise, not fall back: the
    wrappers dispatch on the tensor's device only."""
    from repro_torch.kernels import ops
    src = (PORT / "kernels" / "ops.py").read_text()
    assert "except" not in src and "environ" not in src
    assert ops._on_cpu(torch.zeros(1)) is True
    with pytest.raises(ValueError):
        ops._on_cpu(torch.zeros(1, device="meta"))
