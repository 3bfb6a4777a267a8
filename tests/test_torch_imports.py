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


def test_examples_are_guarded():
    """The examples sub-package is among the guarded files."""
    names = {p.name for p in PORT_FILES if p.parent.name == "examples"}
    assert names == {"__init__.py", "quickstart.py", "elastic_failures.py",
                     "serve_pipeline.py", "train_swarm_lm.py"}


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
    assert torch.equal(int8_roundtrip(x, 64), _roundtrip(x, 64))
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


def test_training_slice_modules_are_in_the_guard():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES if "repro_torch" in str(p)}
    for mod in ("core/swarm.py", "core/trainer.py", "core/dht.py",
                "core/wiring.py", "core/faults.py", "optim/adamw.py",
                "optim/lamb.py", "data/synthetic.py", "train/reference.py",
                "compression/bottleneck.py", "compression/maxout.py",
                "configs/swarm1b.py", "configs/swarm1b_bottleneck.py",
                "configs/swarm1b_maxout.py"):
        assert mod in names, mod
    from repro_torch.configs import get_config
    assert get_config("swarm-1b-bottleneck").bottleneck_dim == 1024
    assert get_config("swarm-1b-maxout").maxout_k == 2


MESH_SLICE = ("dist/__init__.py", "dist/mesh.py", "dist/constrain.py",
              "dist/sharding.py", "dist/pipeline.py", "launch/mesh.py",
              "runtime/mesh.py")


def test_mesh_slice_modules_are_in_the_guard_and_import_without_jax():
    """The mesh slice's modules are guarded, and import (with the
    runtime and the swarm that use them) in a process where ``jax`` and
    ``repro`` cannot be imported at all."""
    import os
    import subprocess
    import sys
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES if "repro_torch" in str(p)}
    assert all(mod in names for mod in MESH_SLICE)
    code = ("import sys\n"
            "sys.modules['jax'] = sys.modules['repro'] = None\n"
            "import repro_torch.dist.pipeline, repro_torch.dist.sharding\n"
            "import repro_torch.launch.mesh, repro_torch.runtime.mesh\n"
            "import repro_torch.core.swarm\n"
            "assert 'jaxlib' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr


DRYRUN_SLICE = ("launch/dryrun.py", "launch/hlo_analysis.py",
                "models/probe.py")


def test_dryrun_slice_modules_are_in_the_guard_and_import_without_jax():
    """The dry run's modules are guarded and import in a process where
    ``jax`` and ``repro`` cannot be imported at all."""
    import os
    import subprocess
    import sys
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES if "repro_torch" in str(p)}
    assert all(mod in names for mod in DRYRUN_SLICE)
    code = ("import sys\n"
            "sys.modules['jax'] = sys.modules['repro'] = None\n"
            "import repro_torch.launch.dryrun, repro_torch.models.probe\n"
            "import repro_torch.launch.hlo_analysis\n"
            "assert 'jaxlib' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("kernels_flag", ["jnp", "pallas"])
def test_wrappers_route_by_device_not_by_config(kernels_flag):
    """``cfg.kernels`` selects nothing: a tensor on a device other than
    the CPU reaches the kernel wrapper whatever the flag says (here the
    ``meta`` device: each call takes its wrapper's meta route, counted
    in ``META_CALLS``, instead of quietly running the plain version),
    and a CPU tensor runs the plain version and launches nothing."""
    from repro_torch import kernels
    from repro_torch.compression import codecs
    from repro_torch.models import layers
    from repro_torch.models.config import ArchConfig
    from repro_torch.models.flash import flash_attention
    base = dict(name="t", family="dense", n_layers=1, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=16,
                compute_dtype="float32", kernels=kernels_flag,
                boundary_compression="bottleneck", bottleneck_dim=32)
    cfg = ArchConfig(**base)
    lcfg = ArchConfig(**{**base, "boundary_compression": "maxout",
                         "maxout_k": 2})
    before = dict(kernels.LAUNCHES)

    def calls(dev):
        x = torch.randn(2, 8, 64, device=dev)
        q = torch.randn(1, 8, 4, 64, device=dev)
        kv = torch.randn(1, 8, 2, 64, device=dev)
        w_c = torch.randn(64, 32, device=dev)
        w_d = torch.randn(32, 64, device=dev)
        return [
            lambda: layers.apply_norm(cfg, {"scale": torch.ones(
                64, device=dev)}, x),
            lambda: flash_attention(q, kv, kv),
            lambda: codecs.int8_boundary(cfg, x),
            lambda: codecs.encode_wire(cfg, "bottleneck", {"w_c": w_c}, x),
            lambda: codecs.encode_wire(lcfg, "maxout", {}, x),
            lambda: codecs.decode_wire(cfg, "bottleneck", {"w_d": w_d},
                                       x[..., :32]),
        ]
    kernels.reset_meta_calls()
    for call in calls("meta"):
        assert call().device.type == "meta"
    assert kernels.META_CALLS == {**dict.fromkeys(kernels.LAUNCHES, 0),
                                  "rmsnorm": 1, "flash_attention_fwd": 1,
                                  "qdq_flat": 1, "encode": 2, "decode": 1}
    kernels.reset_meta_calls()
    for call in calls("cpu"):
        assert call().device.type == "cpu"
    assert kernels.META_CALLS == dict.fromkeys(kernels.LAUNCHES, 0)
    assert kernels.LAUNCHES == before
