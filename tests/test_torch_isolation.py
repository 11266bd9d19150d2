"""The port stands alone: no JAX and nothing of the JAX package.

An AST scan finds no ``jax``, ``llmq_tpu`` or ``ml_dtypes`` import in
``llmq_tpu_torch/`` or ``chip_smoke.py`` (the GPU machine has no
``ml_dtypes``: the snapshot codec carries bf16 / e5m2 pages as raw bits);
a fresh interpreter that imports every port module loads none of them;
the checkpoint loader, the broker, the workers, the command line, the
gateway and the observability modules need none of the packages the GPU
machine lacks (``safetensors``, ``transformers``, ``click``), the client,
the pipelines and the gateway import no PyYAML, ``rich``, ``datasets`` or
torch before they are asked for; and the entry points default to CUDA,
raising here where there is none.
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import llmq_tpu_torch

pytestmark = pytest.mark.unit

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "llmq_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "llmq_tpu", "ml_dtypes")


def test_no_jax_or_reference_imports_in_source():
    offenders = []
    for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders


def _all_port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(llmq_tpu_torch.__path__, "llmq_tpu_torch.")
    )


def test_importing_every_module_loads_no_jax():
    modules = _all_port_modules()
    assert "llmq_tpu_torch.engine.engine" in modules and len(modules) > 20
    assert {"llmq_tpu_torch.obs.metrics", "llmq_tpu_torch.obs.trace",
            "llmq_tpu_torch.obs.exporter", "llmq_tpu_torch.gateway.server"} <= set(modules)
    code = (
        "import sys, importlib\n"
        "before = set(sys.modules)\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "new = sorted(set(sys.modules) - before)\n"
        "bad = [m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'llmq_tpu', 'ml_dtypes')]\n"
        "print(len(new), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


#: packages the GPU machine does not promise, and the modules that must do without
OPTIONAL = ("safetensors", "transformers", "click", "aio_pika")
WORKER_PATH = ("engine/weights.py", "broker/tcp.py", "cli/main.py", "cli/worker.py",
               "__main__.py", "workers/torch_worker.py", "workers/base.py",
               "broker/manager.py", "broker/resilient.py", "broker/filebroker.py",
               "broker/chaos.py", "cli/submit.py", "cli/receive.py", "cli/monitor.py",
               "core/pipeline.py", "core/template.py", "workers/dummy.py", "workers/dedup.py",
               "utils/logging.py", "obs/__init__.py", "obs/metrics.py", "obs/trace.py",
               "obs/exporter.py", "gateway/__init__.py", "gateway/server.py")


def test_loader_broker_and_cli_need_no_optional_package():
    for rel in WORKER_PATH:
        path = PORT / rel
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            assert not [n for n in names if n.split(".")[0] in OPTIONAL], (rel, names)
    code = (
        "import sys\n"
        "import llmq_tpu_torch.cli.main, llmq_tpu_torch.cli.worker, llmq_tpu_torch.broker.tcp\n"
        "import llmq_tpu_torch.broker.manager, llmq_tpu_torch.broker.filebroker\n"
        "import llmq_tpu_torch.broker.chaos, llmq_tpu_torch.workers.base\n"
        "import llmq_tpu_torch.engine.weights, llmq_tpu_torch.cli.submit\n"
        "import llmq_tpu_torch.cli.receive, llmq_tpu_torch.cli.monitor\n"
        "import llmq_tpu_torch.workers.dummy, llmq_tpu_torch.workers.dedup\n"
        "import llmq_tpu_torch.obs, llmq_tpu_torch.gateway\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {OPTIONAL!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_client_and_pipelines_run_without_yaml_rich_or_datasets(tmp_path):
    """The GPU machine may lack PyYAML, rich and datasets: the client and
    the pipeline workers import none of them at module level, a JSON
    pipeline file loads, and the command line parses. The client commands
    import no torch either (a submit starts in a fraction of a second)."""
    path = tmp_path / "p.json"
    path.write_text('{"name": "p", "stages": [{"name": "a", "worker": "dummy"}]}')
    code = (
        "import sys\n"
        "for m in ('yaml', 'rich', 'datasets', 'click', 'torch'): sys.modules[m] = None\n"
        "from llmq_tpu_torch.cli import main, monitor, receive, submit\n"
        "from llmq_tpu_torch import gateway, obs\n"
        "del sys.modules['torch']\n"  # the workers need it; the client does not
        "from llmq_tpu_torch.cli import worker\n"
        "from llmq_tpu_torch.workers import dedup, dummy\n"
        f"cfg = worker.load_pipeline_config({str(path)!r})\n"
        "assert cfg.stage_queue_names() == ['pipeline.p.a'], cfg\n"
        "args = main.build_parser().parse_args(['submit', '-p', 'p.json', 'rows.jsonl'])\n"
        "assert args.is_pipeline\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda():
    from llmq_tpu_torch.cli.worker import build_engine
    from llmq_tpu_torch.device import resolve_device
    from llmq_tpu_torch.engine.engine import EngineCore
    from llmq_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmq_tpu_torch.models.config import ModelConfig
    from llmq_tpu_torch.models.transformer import init_params

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot show")
    cfg = ModelConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        EngineCore(cfg, params, ByteTokenizer())
    with pytest.raises(RuntimeError, match="cuda"):
        build_engine("preset://tiny")
    with pytest.raises(ValueError):
        resolve_device("meta")
