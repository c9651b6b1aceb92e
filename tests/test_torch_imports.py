"""The port stands alone: it imports neither JAX nor anything of the JAX
package (nor flax's ``msgpack``: the port reads and writes flax params
files itself), and its entry points run on the card unless the CPU is
asked for.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import ast
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import frl_distributed_ml_scaffold_tpu_torch as port

REPO = Path(__file__).resolve().parents[1]
PORT_DIR = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack",
             "frl_distributed_ml_scaffold_tpu")


def _modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PORT_DIR)], port.__name__ + ".")
    ) + [port.__name__]


def _sources() -> list[Path]:
    return sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_every_port_module_imports_with_jax_blocked():
    blocked = "; ".join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN)
    imports = "; ".join(f"importlib.import_module({m!r})" for m in _modules())
    code = (
        f"import importlib, sys; {blocked}; sys.path.insert(0, {str(REPO)!r}); "
        f"{imports}; import chip_smoke; "
        "assert not any(k.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[k] is not None for k in sys.modules)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr


def test_scans_cover_every_port_module():
    """Both scans walk the package, so a new module (the quantization
    primitives, say) is covered without being listed here."""
    assert "frl_distributed_ml_scaffold_tpu_torch.ops.quantization" in _modules()
    assert PORT_DIR / "ops" / "quantization.py" in _sources()
    assert "frl_distributed_ml_scaffold_tpu_torch.serving.scheduler" in _modules()
    for mod in ("plan", "executor"):
        assert f"frl_distributed_ml_scaffold_tpu_torch.redistribute.{mod}" \
            in _modules()
        assert PORT_DIR / "redistribute" / f"{mod}.py" in _sources()
    assert "frl_distributed_ml_scaffold_tpu_torch.redistribute" in _modules()
    assert PORT_DIR / "serving" / "scheduler.py" in _sources()
    for rel in ("checkpoint/flax_msgpack.py", "models/dropout.py"):
        name = port.__name__ + "." + rel[:-3].replace("/", ".")
        assert name in _modules()
        assert PORT_DIR / rel in _sources()
    assert len(_sources()) == len(_modules()) + 1  # + chip_smoke.py


@pytest.mark.parametrize("rel", [
    "ops/flash_attention.py", "ops/ring_attention.py", "data/synthetic.py",
    "trainer/tasks.py", "trainer/optimizers.py", "trainer/train_state.py",
    "trainer/train_step.py", "models/vit.py", "models/video.py",
    "models/mlp.py", "data/mnist.py", "data/video.py", "data/pipeline.py",
    "trainer/loop.py", "checkpoint/manager.py", "launcher/launch.py",
    "utils/logging.py", "utils/timing.py", "utils/trees.py",
    "utils/profiling.py", "utils/flops.py", "faults/plan.py",
    "faults/retry.py", "telemetry/metrics.py", "telemetry/timeline.py",
    "telemetry/tracing.py", "telemetry/watchdog.py", "data/native.py",
    "data/shards.py", "data/imagenet.py", "data/lm.py",
    "dist/initialize.py", "dist/mesh.py", "dist/collectives.py",
    "parallel/partition.py", "parallel/layout.py",
    "parallel/tensor_parallel.py", "models/moe.py", "ops/ulysses.py",
    "parallel/pipeline.py", "parallel/mpmd_pipeline.py",
    "parallel/step_utils.py", "data/streaming.py", "utils/debugging.py",
    "launcher/elastic.py",
], ids=lambda r: r.replace("/", "."))
def test_scans_cover_the_training_modules(rel):
    """The training slice's modules are among those both scans walk."""
    name = "frl_distributed_ml_scaffold_tpu_torch." + rel[:-3].replace("/", ".")
    assert name in _modules()
    assert PORT_DIR / rel in _sources()


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_import_in_the_port(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points do not raise")


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    _no_card()
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        GPTConfig,
        ServingConfig,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.generation import (
        beam_search,
        generate,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.serving import (
        DisaggServingEngine,
        ServingEngine,
        build_engine,
    )

    cfg = GPTConfig(vocab_size=64, num_layers=1, num_heads=2, hidden_dim=64,
                    seq_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(cfg, get_policy("fp32"))
    model = GPT(cfg, get_policy("fp32"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(model, [[1, 2, 3]], max_new_tokens=2, temperature=0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(model, serving=ServingConfig())
    disagg = ServingConfig(kv_block_size=16, disaggregate=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggServingEngine(model, serving=disagg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(model, serving=disagg)
    out = generate(model, [[1, 2, 3]], max_new_tokens=2, temperature=0.0,
                   device="cpu")
    assert tuple(out.shape) == (1, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        beam_search(model, [[1, 2, 3]], max_new_tokens=2, num_beams=2)
    out, _ = beam_search(model, [[1, 2, 3]], max_new_tokens=2, num_beams=2,
                         device="cpu")
    assert tuple(out.shape) == (1, 5)


def test_training_entry_points_default_to_cuda_and_raise_without_a_card():
    _no_card()
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        GPTConfig,
        OptimizerConfig,
        TrainerConfig,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
    from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
        make_optimizer,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.tasks import make_lm_loss
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_state import (
        TrainState,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_eval_step,
        make_train_step,
    )

    cfg = GPTConfig(vocab_size=64, num_layers=1, num_heads=2, hidden_dim=64,
                    seq_len=32, attention="flash")
    model = GPT(cfg, get_policy("fp32"), device="cpu")
    tx, _ = make_optimizer(OptimizerConfig(), TrainerConfig(), cfg)
    params = dict(model.named_parameters())
    loss = make_lm_loss(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainState.create(params, tx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(loss, tx, get_policy("fp32"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(loss, get_policy("fp32"))
    state = TrainState.create(params, tx, device="cpu")
    step = make_train_step(loss, tx, get_policy("fp32"), device="cpu")
    tokens = torch.randint(0, 64, (2, 33))
    state, metrics = step(state, {"tokens": tokens})
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        MLPConfig,
        VideoConfig,
        ViTConfig,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models import create_model

    for own in (MLPConfig(), ViTConfig(), VideoConfig()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model(own, get_policy("fp32"))
    from frl_distributed_ml_scaffold_tpu_torch.config import get_config
    from frl_distributed_ml_scaffold_tpu_torch.launcher.launch import main
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_config("mnist_mlp"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config=mnist_mlp", "data.global_batch_size=8"])
    assert Trainer(get_config("mnist_mlp"), device="cpu").device.type == "cpu"


def test_distributed_entry_points_default_to_cuda_and_raise_without_a_card():
    """A multi-process run defaults to NCCL on the cards and raises
    without one; gloo is only for the CPU when asked for. One process
    initialises nothing."""
    _no_card()
    import torch.distributed as dist

    from frl_distributed_ml_scaffold_tpu_torch.dist.initialize import (
        initialize_distributed,
        local_device,
    )
    from frl_distributed_ml_scaffold_tpu_torch.launcher.launch import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed("localhost:1", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        local_device(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config=mnist_mlp", "--num-processes=2", "--process-id=1",
              "--coordinator=localhost:1"])
    initialize_distributed("localhost:1", 1, 0)
    assert not dist.is_initialized()
    assert local_device(3, "cpu") == torch.device("cpu")


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "script_alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """``chip_smoke.py`` exits non-zero and prints no result on a box
    without a card, in the repository and copied out of it alone."""
    _no_card()
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=120, cwd=script.parent,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
