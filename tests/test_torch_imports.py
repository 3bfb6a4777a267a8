"""Guards of the port's boundaries: it never imports JAX or the JAX
package, its kernel wrappers take the plain version only for CPU
tensors, and asking for the card where there is none raises."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(path: pathlib.Path) -> list[str]:
    """``file:line: module`` for every import of jax or the JAX package
    (``repro_torch`` itself is allowed)."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.name}:{node.lineno}: {n}")
    return bad


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    assert _forbidden(path) == []


def test_guard_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.models import x\n"
                 "from repro_torch.models import y\nimport repro\n")
    assert _forbidden(f) == ["m.py:1: jax.numpy", "m.py:2: repro.models",
                             "m.py:4: repro"]


def test_pallas_wrappers_take_plain_version_on_cpu():
    from repro_torch import kernels
    from repro_torch.compression.quant8 import _roundtrip
    from repro_torch.kernels.boundary.ops import int8_roundtrip
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import layers
    from repro_torch.models.config import ArchConfig
    cfg = ArchConfig(name="t", family="dense", n_layers=1, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=16,
                     compute_dtype="float32", kernels="pallas")
    before = dict(kernels.LAUNCHES)
    x = torch.randn(3, 64)
    s = torch.rand(64) + 0.5
    assert torch.equal(layers.apply_norm(cfg, {"scale": s}, x),
                       rmsnorm_ref(x, s))
    assert torch.equal(int8_roundtrip(x, 64, use_kernel=True),
                       _roundtrip(x, 64))
    assert kernels.LAUNCHES == before


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.params import from_numpy_tree
    from repro_torch.serve import ServeRunner
    cfg = ArchConfig(name="t", family="dense", n_layers=4, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=16,
                     compute_dtype="float32")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeRunner(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeRunner(cfg)                         # the default is the card
    with pytest.raises(RuntimeError, match="cuda"):
        from_numpy_tree({"a": __import__("numpy").zeros(2)})
