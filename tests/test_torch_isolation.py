"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU when there is no card."""
import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import tiny_config
from repro_torch.core import EngineConfig, InferenceEngine
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax():
    """In a fresh interpreter where ``import jax`` fails, every module of the
    port imports, and no ``repro.*`` or ``jax*`` module gets loaded."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'repro' or m.startswith('repro.')"
        " or m.startswith('jax'))\n"
        "assert bad == ['jax'], bad\n"
        "assert sys.modules['jax'] is None\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_examples_import_without_jax():
    """The examples' torch twins import in a fresh interpreter where
    ``import jax`` fails, loading no ``repro.*`` module."""
    names = sorted(f.stem for f in (ROOT / "examples").glob("*_torch.py"))
    assert names == ["dynamic_load_balancing_torch", "quickstart_torch", "serve_endpoint_torch"]
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'repro' or m.startswith('repro.'))\n"
        "assert bad == [], bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'examples'}", "PATH": ""},
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b|from repro\.)")
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(ROOT.glob("chip_*.py"))
             + sorted((ROOT / "examples").glob("*_torch.py")))
    assert len(files) > 6 and ROOT / "chip_smoke.py" in files
    assert ROOT / "examples" / "dynamic_load_balancing_torch.py" in files
    hits = [f"{f}:{i}" for f in files for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert hits == []


def test_module_list_is_complete():
    names = _modules()
    for m in ("repro_torch.core.engine", "repro_torch.kernels.paged_attention.kernel",
              "repro_torch.kernels.moe_gmm.ops", "repro_torch.models.transformer",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.kernels.flash_attention.ops", "repro_torch.kernels.flash_attention.ref",
              "repro_torch.kernels.paged_attention.ops", "repro_torch.models.attention",
              "repro_torch.configs.gemma2_27b", "repro_torch.configs.mamba2_1_3b",
              "repro_torch.configs.jamba_v0_1_52b", "repro_torch.models.mamba",
              "repro_torch.kernels.ssd_scan.kernel", "repro_torch.kernels.ssd_scan.ops",
              "repro_torch.kernels.ssd_scan.ref", "repro_torch.quant.quantize",
              "repro_torch.kernels.quant_matmul.kernel", "repro_torch.kernels.quant_matmul.ops",
              "repro_torch.kernels.quant_matmul.ref", "repro_torch.core.replica",
              "repro_torch.core.router", "repro_torch.core.gateway", "repro_torch.core.client",
              "repro_torch.core.serde", "repro_torch.core.safety", "repro_torch.core.faults",
              "repro_torch.core.dashboard", "repro_torch.data.workload",
              "repro_torch.launch.serve", "repro_torch.core.spec",
              "repro_torch.configs.yi_6b", "repro_torch.configs.phi3_mini_3_8b",
              "repro_torch.configs.dbrx_132b", "repro_torch.configs.deepseek_moe_16b",
              "repro_torch.kernels.grad_guard", "repro_torch.data.pipeline",
              "repro_torch.training", "repro_torch.training.optimizer",
              "repro_torch.training.train_step", "repro_torch.training.trainer",
              "repro_torch.distributed", "repro_torch.distributed.collectives",
              "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
              "repro_torch.launch.train", "repro_torch.launch.dryrun",
              "repro_torch.launch.roofline", "repro_torch.launch.report",
              "repro_torch.kernels.route"):
        assert m in names
    for m in names:
        importlib.import_module(m)


@pytest.mark.parametrize("entry", ["engine", "init_params", "init_cache", "init_cache_paged",
                                   "train", "train_cli", "dryrun_cuda", "quickstart"])
def test_no_silent_cpu_fallback(entry):
    """Without a card and without ``device="cpu"``, entry points raise: the
    engine, the params, both kinds of cache (``init_cache`` defaults to
    the dense ring cache, as the reference's), the trainer, the training
    launcher, the dry-run's memory proof (``--device cuda``) and the
    examples (quickstart's ``main`` stands for the three)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    model = build_model(tiny_config("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "engine":
            InferenceEngine(model, model.init_params(0, device="cpu"), EngineConfig())
        elif entry == "init_params":
            model.init_params(0)
        elif entry == "init_cache":
            model.init_cache(2, 8)
        elif entry == "init_cache_paged":
            model.init_cache(2, 8, kind="paged", num_pages=8)
        elif entry == "train":
            from repro_torch.data.pipeline import DataConfig
            from repro_torch.training import TrainConfig
            from repro_torch.training.trainer import TrainerConfig, train
            train(model, DataConfig(vocab=model.cfg.vocab, batch=2, seq_len=8), TrainConfig(),
                  TrainerConfig(steps=1))
        elif entry == "train_cli":
            from repro_torch.launch.train import main
            main(["--steps", "1"])
        elif entry == "dryrun_cuda":
            from repro_torch.launch.dryrun import run_cell
            run_cell("qwen2.5-3b", "decode_32k", multi_pod=False, device="cuda")
        else:
            sys.path.insert(0, str(ROOT / "examples"))
            try:
                importlib.import_module("quickstart_torch").main([])
            finally:
                sys.path.remove(str(ROOT / "examples"))


def test_kernel_build_is_keyed_by_source_and_raises_without_nvcc(monkeypatch, tmp_path):
    """Each kernel library's name carries a hash of its sources and flags;
    a build that cannot run raises instead of leaving the op without its
    kernel."""
    from repro_torch.kernels import build
    paths = {name: build.library_path(name) for name in build.KERNELS}
    assert len(set(paths.values())) == len(paths)
    for name, p in paths.items():
        assert re.fullmatch(rf"lib{name}-[0-9a-f]{{16}}\.so", p.name)
        assert build.library_path(name) == p
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("the CUDA toolkit is installed: the build would succeed")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["moe_gmm"])
    assert not (tmp_path / "kernels").exists()
