"""Import contract of the PyTorch port (capital_tpu_torch).

The port imports torch, numpy and the standard library only: never jax, and
nothing of the JAX package capital_tpu (whose name is a prefix of the
port's, so the checks below match `capital_tpu` and `capital_tpu.`
exactly).
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capital_tpu_torch import Grid
from capital_tpu_torch.utils.interop import tensor_from_numpy, tensor_to_numpy

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "capital_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return (
        name == "jax" or name.startswith("jax.")
        or name == "capital_tpu" or name.startswith("capital_tpu.")
        or name == "jaxlib" or name.startswith("jaxlib.")
    )


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import sys, capital_tpu_torch\n"
        "import capital_tpu_torch.utils.interop, capital_tpu_torch.utils.residual\n"
        "import capital_tpu_torch.models.qr, capital_tpu_torch.ops.qr_fused\n"
        "import capital_tpu_torch.ops.tsqr, capital_tpu_torch.robust.recovery\n"
        "import capital_tpu_torch.robust.faultinject\n"
        "import capital_tpu_torch.ops.batched_small, capital_tpu_torch.serve.api\n"
        "import capital_tpu_torch.serve.batching, capital_tpu_torch.serve.engine\n"
        "import capital_tpu_torch.models.inverse, capital_tpu_torch.models.trsm\n"
        "import capital_tpu_torch.models.blocktri, capital_tpu_torch.models.arrowhead\n"
        "import capital_tpu_torch.models.banded, capital_tpu_torch.ops.blocktri_small\n"
        "import capital_tpu_torch.ops.update_small, capital_tpu_torch.robust.refine\n"
        "import capital_tpu_torch.parallel.mesh\n"
        "import capital_tpu_torch.serve, capital_tpu_torch.serve.program\n"
        "import capital_tpu_torch.obs.spans, capital_tpu_torch.obs.ledger\n"
        "import capital_tpu_torch.serve.factorcache, capital_tpu_torch.serve.sessions\n"
        "import capital_tpu_torch.serve.telemetry, capital_tpu_torch.serve.loadgen\n"
        "import capital_tpu_torch.serve.replica, capital_tpu_torch.serve.router\n"
        "import capital_tpu_torch.serve.__main__, capital_tpu_torch.serve.cache\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'capital_tpu')"
        " or m.startswith(('jax.', 'jaxlib.', 'capital_tpu.')))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True
    )
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_capital_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)]


def test_cholesky_qr2_slice_files_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("models/qr.py", "ops/qr_fused.py", "ops/tsqr.py", "robust/recovery.py",
              "robust/faultinject.py"):
        assert "capital_tpu_torch/" + f in names


def test_small_n_slice_files_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("ops/batched_small.py", "serve/api.py", "serve/batching.py", "serve/engine.py",
              "serve/__init__.py"):
        assert "capital_tpu_torch/" + f in names


def test_inversion_slice_files_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("models/inverse.py", "models/trsm.py", "ops/tsqr.py", "ops/lapack.py",
              "ops/hopper.py", "ops/sweeps.py", "utils/interop.py"):
        assert "capital_tpu_torch/" + f in names


def test_update_and_refine_slice_files_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("ops/update_small.py", "robust/refine.py", "ops/lapack.py", "serve/api.py"):
        assert "capital_tpu_torch/" + f in names


def test_residency_and_session_slice_files_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("serve/factorcache.py", "serve/sessions.py", "serve/engine.py", "serve/api.py",
              "serve/batching.py", "serve/program.py", "utils/tracing.py"):
        assert "capital_tpu_torch/" + f in names


def test_frontend_slice_files_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("serve/telemetry.py", "serve/loadgen.py", "serve/replica.py", "serve/router.py",
              "serve/__main__.py", "serve/cache.py", "obs/ledger.py", "__init__.py"):
        assert "capital_tpu_torch/" + f in names


HOST_ONLY = ("router", "replica", "loadgen", "telemetry")


@pytest.mark.parametrize("mod", HOST_ONLY)
def test_host_only_modules_load_no_torch(mod):
    """A router pump or a loadgen client process imports these without a
    device runtime: neither torch nor jax lands in sys.modules."""
    code = (
        f"import sys, capital_tpu_torch.serve.{mod} as m\n"
        "import capital_tpu_torch, capital_tpu_torch.serve\n"
        "bad = sorted(x for x in sys.modules if x in ('torch', 'jax', 'jaxlib', 'capital_tpu')"
        " or x.startswith(('torch.', 'jax.', 'jaxlib.', 'capital_tpu.')))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True
    )
    assert out.stdout.strip() == ""


def test_lazy_exports_resolve():
    import capital_tpu_torch
    import capital_tpu_torch.serve as serve

    assert capital_tpu_torch.Grid is Grid
    assert capital_tpu_torch.cholesky.__name__ == "capital_tpu_torch.models.cholesky"
    assert sorted(capital_tpu_torch.__all__) == capital_tpu_torch.__all__
    for name in serve.__all__:
        assert getattr(serve, name).__name__ == name
    with pytest.raises(AttributeError):
        capital_tpu_torch.not_a_name  # noqa: B018
    with pytest.raises(AttributeError):
        serve.not_a_name  # noqa: B018


def test_grid_without_device_needs_cuda():
    if torch.cuda.is_available():
        assert Grid.square().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Grid.square()
    assert Grid.square(device="cpu").platform == "cpu"
    # one device cannot form a d x d x 2 grid: the reference's error
    with pytest.raises(ValueError, match="num_devices=1 not divisible by c=2"):
        Grid.square(c=2, device="cpu")


def test_bf16_round_trip_is_bitwise():
    bits = np.random.default_rng(0).integers(0, 2**16, size=(17, 5), dtype=np.uint16)
    bits[0, :4] = [0x7FC0, 0xFF80, 0x0001, 0x8000]  # NaN, -inf, denormal, -0
    a = bits.view(jnp.bfloat16)
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16 and t.shape == (17, 5)
    assert np.array_equal(tensor_to_numpy(t), bits)
    back = tensor_to_numpy(t).view(jnp.bfloat16)
    assert np.array_equal(back.view(np.uint16), bits)


def test_obs_and_lint_slice_files_are_scanned():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("obs/__init__.py", "obs/ledger.py", "obs/__main__.py", "obs/spans.py",
              "lint/__init__.py", "lint/__main__.py", "lint/rules.py", "lint/baseline.py",
              "lint/source.py", "lint/invariants.py", "lint/concurrency.py", "lint/schedule.py"):
        assert "capital_tpu_torch/" + f in names


HOST_TOOLS = (
    "import capital_tpu_torch.obs.ledger, capital_tpu_torch.obs.__main__\n"
    "import capital_tpu_torch.lint, capital_tpu_torch.lint.__main__\n"
    "import capital_tpu_torch.lint.concurrency, capital_tpu_torch.lint.schedule\n"
    "import capital_tpu_torch.lint.invariants, capital_tpu_torch.lint.baseline\n",
    # the CLIs' own runs: a lint pass with its ledger record, a report of it,
    # the robust gate and the static concurrency pass
    "import tempfile, os\n"
    "from capital_tpu_torch.obs import __main__ as obs\n"
    "from capital_tpu_torch.lint import __main__ as lint\n"
    "led = os.path.join(tempfile.mkdtemp(), 'l.jsonl')\n"
    "assert lint.main(['source', 'capital_tpu_torch', '--ledger', led]) == 0\n"
    "assert lint.main(['concurrency', '--static-only', '--ledger', led]) == 0\n"
    "assert obs.main(['lint-report', led, '--require-pass', 'source']) == 0\n"
    "assert obs.main(['serve-report', led]) == 0 and obs.main(['robust-gate']) == 0\n"
    "assert obs.main(['diff', led, led]) == 0\n",
)


@pytest.mark.parametrize("code", HOST_TOOLS, ids=("imports", "runs"))
def test_obs_and_lint_load_no_torch(code):
    """The obs and lint CLIs read files and touch no device: neither torch
    nor jax lands in sys.modules (the explorer's FactorCache scenario is
    the one place that imports torch, inside the scenario)."""
    probe = (
        "import sys\n" + code
        + "bad = sorted(x for x in sys.modules if x in ('torch', 'jax', 'jaxlib', 'capital_tpu')"
        " or x.startswith(('torch.', 'jax.', 'jaxlib.', 'capital_tpu.')))\n"
        "print('BAD=' + ','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, check=True
    )
    assert out.stdout.strip().splitlines()[-1] == "BAD="
