"""dsm_tpu_torch stands alone: every module imports with JAX blocked and
pulls in nothing of the JAX package."""

import os
import pkgutil
import subprocess
import sys
import textwrap

import dsm_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    names = ["dsm_tpu_torch"]
    for info in pkgutil.walk_packages(dsm_tpu_torch.__path__, "dsm_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax():
    names = _all_modules()
    assert "dsm_tpu_torch.server.batched_asr" in names
    assert "dsm_tpu_torch.ops.decode_attn" in names
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None  # any import of jax now raises
        for name in {names!r}:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m == "dsm_tpu" or m.startswith("dsm_tpu."))
        assert not leaked, leaked
        print("ok", len({names!r}))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_imports_nothing_of_jax():
    """The root chip_smoke.py names neither jax nor the JAX package."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    for line in src.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            assert "jax" not in stripped
            assert not stripped.split()[1].startswith("dsm_tpu.")
            assert stripped.split()[1] != "dsm_tpu"
