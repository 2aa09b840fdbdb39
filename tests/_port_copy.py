"""Run the reference's test modules on the port's copies of what they test.

The port keeps verbatim copies of the reference's framework-free modules
(``obs/``, ``runtime/adaptive.py``, ``runtime/rrfp/``, ``core/``), so the
reference's own tests of them apply unchanged.  :func:`port_cases` executes
a reference test file with every ``repro.`` import rewritten to
``repro_torch.`` and puts its test functions, test classes and fixtures
into the calling module's namespace, where pytest collects them under
their own names.  A helper module the file imports by its bare name
(``harness``) is loaded the same way, rewritten, as ``port_<name>``.
"""
from __future__ import annotations

import re
import sys
import types
from pathlib import Path

from _pytest.fixtures import FixtureFunctionDefinition

TESTS = Path(__file__).resolve().parent


def _port_source(path: Path, helpers: tuple[str, ...]) -> str:
    src = re.sub(r"\brepro\.", "repro_torch.", path.read_text())
    src = re.sub(r"\bfrom repro import\b", "from repro_torch import", src)
    for name in helpers:
        src = re.sub(rf"^from {name} import", f"from port_{name} import", src,
                     flags=re.M)
    return src


def load_port_module(relpath: str, helpers: tuple[str, ...] = ()):
    """The reference test module (or helper) at ``tests/<relpath>``,
    rewritten onto the port and registered as ``port_<stem>``."""
    path = TESTS / relpath
    for name in helpers:
        if f"port_{name}" not in sys.modules:
            load_port_module(str(Path(relpath).parent / f"{name}.py"))
    name = f"port_{path.stem}"
    if name in sys.modules:
        return sys.modules[name]
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod  # dataclasses resolve their module by name
    exec(compile(_port_source(path, helpers), str(path), "exec"),
         mod.__dict__)
    return mod


def port_cases(relpath: str, namespace: dict, *,
               helpers: tuple[str, ...] = (), skip: tuple[str, ...] = ()
               ) -> list[str]:
    """Collect the reference module's tests and fixtures into
    ``namespace``; returns their names.  A name already taken raises."""
    mod = load_port_module(relpath, helpers)
    names = []
    for k, v in vars(mod).items():
        if k in skip or not (k.startswith(("test", "Test"))
                             or isinstance(v, FixtureFunctionDefinition)):
            continue
        if k in namespace:
            raise NameError(f"{relpath}: {k} is already defined here")
        namespace[k] = v
        names.append(k)
    return names
