"""The port stands alone: no file of ``src/repro_torch`` or
``chip_smoke.py`` imports JAX or anything of the reference package
``repro``, and every module imports on a host without nvcc or a GPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "jaxlib", "repro"))


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, ("." * node.level) + (node.module or "")
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name)
                    and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "import_module"))):
            yield node.lineno, node.args[0].value


def test_port_files_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for mod in ("schema.py", "core/miniconv.py", "core/passplan.py",
                "core/backends.py", "nn/module.py", "nn/layers.py",
                "kernels/ref.py", "kernels/ops.py", "kernels/_build.py",
                "kernels/miniconv_pass.py", "core/wire.py", "core/split.py",
                "core/tuning.py", "rl/networks.py", "serving/server.py",
                "serving/client.py", "deploy.py", "convert.py",
                "perfstamp.py", "benchmarks/frame_time.py",
                "models/config.py", "configs/__init__.py",
                "configs/qwen3_0_6b.py", "nn/rotary.py", "nn/attention.py",
                "kernels/flash_attention.py", "models/blocks.py",
                "models/transformer.py", "models/registry.py",
                "serving/netsim.py", "launch/serve.py", "core/latency.py",
                "serving/fleet.py", "serving/profiles.py",
                "serving/scenario.py", "benchmarks/decision_latency.py",
                "benchmarks/break_even.py", "benchmarks/scalability.py",
                "examples/quickstart.py", "serving/realfleet.py",
                "benchmarks/realfleet.py", "benchmarks/sustained.py",
                "benchmarks/scenarios.py", "examples/deploy_policy.py",
                "train/__init__.py", "train/optimizer.py",
                "envs/__init__.py", "envs/base.py", "envs/rendering.py",
                "envs/pendulum.py", "envs/hopper.py", "envs/walker.py",
                "envs/wrappers.py", "rl/buffers.py", "rl/agent.py",
                "rl/ddpg.py", "rl/sac.py", "rl/ppo.py", "rl/rollout.py",
                "rl/train.py", "examples/train_split_policy.py",
                "rl/population.py", "benchmarks/population.py",
                "benchmarks/learning.py", "nn/constrain.py",
                "models/sharding.py", "launch/mesh.py", "launch/steps.py",
                "costs.py", "launch/roofline.py", "launch/dryrun.py",
                "launch/perf.py", "analysis/__init__.py",
                "analysis/__main__.py", "analysis/core.py",
                "analysis/baseline.py", "analysis/rules_concurrency.py",
                "analysis/rules_rng.py", "analysis/rules_timing.py",
                "analysis/rules_schema.py", "analysis/rules_kernel.py",
                "tracing.py", "kernels/ssd_scan.py",
                "kernels/moe_combine.py"):
        assert mod in names, mod
    assert len([n for n in names if n.startswith("configs/")]) == 12
    assert {p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")} == \
        {"miniconv_encoder.cu", "miniconv_layer.cu", "flash_attention.cu",
         "moe_grouped.cu", "ssd_scan.cu", "moe_combine.cu"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_no_jax_and_no_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, name) for line, name in _imports(tree)
           if _forbidden(name) or name.startswith(".")]
    assert not bad, f"{path}: forbidden or relative imports {bad}"


def test_every_module_imports_without_jax_or_a_gpu():
    """Import every port module in a fresh interpreter: none pulls in jax
    or the reference, and none needs nvcc, triton or a card to import."""
    mods = sorted("repro_torch." + p.relative_to(PORT).with_suffix("")
                  .as_posix().replace("/", ".").replace(".__init__", "")
                  for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
