"""The port's public names: every subpackage of ``repro`` that has an
``__init__`` exports its names from the port's counterpart too, apart from
the listed exceptions; and the example and tool twins import neither
``jax`` nor ``repro``."""
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

# names of the reference's packages that the port leaves out, and why
EXCEPTIONS = {
    "distributed": {
        "mesh_compat": "the jax shim between mesh APIs; the port's meshes are DeviceMeshes",
        "use_mesh": "mesh_compat's ambient jax mesh; a port step takes its mesh as an argument",
        "get_abstract_mesh": "mesh_compat's, likewise",
        "resolve_mesh": "mesh_compat's, likewise",
    },
    "configs": {
        "Dict": "a typing import the reference's __init__ leaks, not a name of the package",
    },
}

PACKAGES = sorted(
    os.path.relpath(root, os.path.join(SRC, "repro")).replace(os.sep, ".")
    for root, _, files in os.walk(os.path.join(SRC, "repro"))
    if "__init__.py" in files and root != os.path.join(SRC, "repro"))

TWINS = ["examples/torch_quickstart.py", "examples/torch_serve_recommendations.py",
         "examples/torch_train_at_scale.py", "examples/torch_eval_on_stream.py",
         "examples/torch_implicit_stream.py", "examples/torch_multiarch_dryrun.py",
         "tools/torch_scale_smoke.py", "tools/torch_chaos_smoke.py"]


def test_every_package_with_an_init_is_checked():
    assert {"core", "checkpoint", "optim", "distributed", "kernels", "serving.fleet"} <= set(
        PACKAGES)
    for pkg, names in EXCEPTIONS.items():
        ref = importlib.import_module(f"repro.{pkg}")
        assert all(hasattr(ref, n) for n in names), pkg


@pytest.mark.parametrize("pkg", PACKAGES)
def test_the_port_exports_the_references_public_names(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    skip = EXCEPTIONS.get(pkg, {})
    missing = []
    for name in sorted(n for n in dir(ref) if not n.startswith("_") and n not in skip):
        value = getattr(ref, name)
        if isinstance(value, types.ModuleType):
            if value.__name__ != f"repro.{pkg}.{name}":
                continue  # a module the __init__ imports (importlib), not its own
            # a submodule: the port has one of that name
            ok = importlib.util.find_spec(f"repro_torch.{pkg}.{name}") is not None
        else:
            ok = hasattr(port, name)
        if not ok:
            missing.append(name)
    assert not missing, f"repro_torch.{pkg} lacks {missing}"


IMPORTS = r'''
import importlib.util, json, sys
for path in %r:
    name = "twin_" + path.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert callable(module.main), path
bad = sorted(m for m in sys.modules if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LOADED " + json.dumps(bad))
''' % (TWINS,)


def test_the_twins_import_neither_jax_nor_the_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(IMPORTS)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    line = [x for x in proc.stdout.splitlines() if x.startswith("LOADED ")]
    assert proc.returncode == 0 and line, proc.stdout + proc.stderr
    assert line[0] == "LOADED []"


EACH_FIRST = r'''
import importlib, json, pkgutil, sys
import torch  # noqa: F401
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
failed = {}
for name in names:
    for key in [k for k in sys.modules if k == "repro_torch" or k.startswith("repro_torch.")]:
        del sys.modules[key]
    try:
        importlib.import_module(name)
    except Exception as exc:  # noqa: BLE001 (reported)
        failed[name] = repr(exc)
print("IMPORTED " + json.dumps([len(names), failed]))
'''


def test_every_module_of_the_port_imports_first():
    """Each module imported first into a fresh ``repro_torch`` (as a spawned
    replica or a launcher imports it): the packages' exports make no
    circular import."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(EACH_FIRST)], env=env,
                          capture_output=True, text=True, timeout=120)
    line = [x for x in proc.stdout.splitlines() if x.startswith("IMPORTED ")]
    assert proc.returncode == 0 and line, proc.stdout + proc.stderr
    count, failed = json.loads(line[0][len("IMPORTED "):])
    assert count > 80 and failed == {}
