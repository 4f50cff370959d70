# -*- coding: utf-8 -*-
"""
The port's public surface against the JAX package's, live: every module
of quakemigrate_tpu has its quakemigrate_torch module;
each public name defined in it (a function, class or jitted function
whose ``__module__`` is the module, or for a package one of its
submodules; or a plain value: number, string, container, array) exists
there; each public attribute of each class exists on the port's class;
and each parameter of each function and method exists in the port's
signature with an equal default. The port may add parameters (device,
dtype) and may not drop any.

Every difference the port keeps is in ALLOWLIST with its reason: either
"excluded: why" or "counterpart: dotted name", and each counterpart must
resolve. An entry no module reaches is stale and fails the test.

"""

import importlib
import inspect
import pathlib
import types

import numpy as np
import pytest

import quakemigrate_tpu

ALLOWLIST = {
    "quakemigrate_tpu.ops.pallas_migrate":
        "counterpart: quakemigrate_torch.ops.cuda_migrate",
    "quakemigrate_tpu.ops.scan_window.detect_window_fused_mxu":
        "counterpart: quakemigrate_torch.ops.scan_window.detect_window_cuda",
    "quakemigrate_tpu.ops.scan_window.detect_window_fused_kurtosis_mxu":
        "counterpart: quakemigrate_torch.ops.scan_window.detect_window_cuda",
    "quakemigrate_tpu.util.host_cpu_jax":
        "excluded: JAX machinery (a host-CPU JAX device)",
    "quakemigrate_tpu.util.enable_compilation_cache":
        "excluded: JAX machinery (XLA's compilation cache)",
    "quakemigrate_tpu.core.name":
        "excluded: a loop variable left at module level by the native "
        "library's bindings, not an API",
}

PLAIN_VALUES = (bool, int, float, complex, str, bytes, tuple, list, dict,
                set, frozenset, np.ndarray, np.generic)


def _jax_modules():
    """Every module of the JAX package, by its file (nothing imported)."""

    root = pathlib.Path(quakemigrate_tpu.__file__).parent
    names = []
    for path in root.rglob("*.py"):
        parts = path.relative_to(root.parent).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    return sorted(names)


JAX_MODULES = _jax_modules()
_reached = set()


def _port_name(name):
    return "quakemigrate_torch" + name[len("quakemigrate_tpu"):]


def _resolve(dotted):
    """The object a dotted name names (a module, or an attribute path
    inside the longest importable module prefix)."""

    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(dotted)


def _allowed(key):
    """True where ALLOWLIST excuses ``key`` (and its counterpart
    resolves)."""

    reason = ALLOWLIST.get(key)
    if reason is None:
        return False
    _reached.add(key)
    if reason.startswith("counterpart: "):
        _resolve(reason[len("counterpart: "):])
    else:
        assert reason.startswith("excluded: "), (key, reason)
    return True


def _public_names(module):
    """The public names the module defines, as the docstring says."""

    package = hasattr(module, "__path__")
    top = module.__name__ == "quakemigrate_tpu"
    found = {}
    for name, obj in vars(module).items():
        if name.startswith("_") or isinstance(obj, types.ModuleType):
            continue
        if isinstance(obj, PLAIN_VALUES):
            found[name] = obj
            continue
        if not (inspect.isclass(obj) or callable(obj)):
            continue
        owner = getattr(obj, "__module__", None) or ""
        if (owner == module.__name__
                or (package and owner.startswith(module.__name__ + "."))
                or (top and owner.startswith("quakemigrate_tpu."))):
            found[name] = obj
    return found


def _same_default(a, b):
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if type(a) is not type(b):
        return False
    try:
        return bool(a == b) or (a != a and b != b)
    except (TypeError, ValueError):
        return repr(a) == repr(b)


def _signature_gaps(jax_fn, port_fn, label):
    try:
        want = inspect.signature(jax_fn)
    except (TypeError, ValueError):
        return []
    try:
        have = inspect.signature(port_fn).parameters
    except (TypeError, ValueError):
        return [f"{label}: no signature"]
    gaps = []
    for param in want.parameters.values():
        if param.name not in have:
            gaps.append(f"{label}: parameter {param.name} missing")
        elif not _same_default(param.default, have[param.name].default):
            gaps.append(f"{label}: default of {param.name} "
                        f"{param.default!r} != "
                        f"{have[param.name].default!r}")
    return gaps


def _class_gaps(jax_cls, port_cls, label):
    gaps = _signature_gaps(jax_cls.__init__, port_cls.__init__,
                           f"{label}.__init__")
    for attr in dir(jax_cls):
        if attr.startswith("_"):
            continue
        if _allowed(f"{jax_cls.__module__}.{jax_cls.__qualname__}.{attr}"):
            continue
        if not hasattr(port_cls, attr):
            gaps.append(f"{label}.{attr} missing")
            continue
        static = inspect.getattr_static(jax_cls, attr)
        if isinstance(static, (types.FunctionType, staticmethod,
                               classmethod)):
            gaps += _signature_gaps(getattr(jax_cls, attr),
                                    getattr(port_cls, attr),
                                    f"{label}.{attr}")
    return gaps


def _module_allowed(name):
    """True where ALLOWLIST excuses the module or a package holding it."""

    parts = name.split(".")
    return any(_allowed(".".join(parts[:i]))
               for i in range(len(parts), 1, -1))


@pytest.mark.parametrize("name", JAX_MODULES)
def test_module_surface(name):
    if _module_allowed(name):
        return
    port_name = _port_name(name)
    jax_module = importlib.import_module(name)
    port_module = importlib.import_module(port_name)
    gaps = []
    for attr, obj in _public_names(jax_module).items():
        if _allowed(f"{name}.{attr}"):
            continue
        label = f"{port_name}.{attr}"
        if not hasattr(port_module, attr):
            gaps.append(f"{label} missing")
            continue
        port_obj = getattr(port_module, attr)
        if inspect.isclass(obj):
            if not inspect.isclass(port_obj):
                gaps.append(f"{label} is not a class")
                continue
            gaps += _class_gaps(obj, port_obj, label)
        elif callable(obj):
            gaps += _signature_gaps(obj, port_obj, label)
    assert not gaps, "\n".join(gaps)


# Entries that name an attribute the JAX package defines only in some
# processes: quakemigrate_tpu.core binds its native library's functions,
# and leaves ``name`` behind, only where the library loaded, and it
# compiles that library in place at import, so a process that imports it
# while another writes the file may load none. Such an entry is required
# exactly when its attribute exists.
CONDITIONAL = {"quakemigrate_tpu.core.name"}


def _required_entries():
    """The ALLOWLIST entries the walk must reach in this process."""

    required = set()
    for key in ALLOWLIST:
        if key in CONDITIONAL:
            module, attr = key.rsplit(".", 1)
            if not hasattr(importlib.import_module(module), attr):
                continue
        required.add(key)
    return required


def _check_allowlist():
    _reached.clear()
    for name in JAX_MODULES:
        test_module_surface(name)
    assert _required_entries() == _reached, _required_entries() - _reached
    for key, reason in ALLOWLIST.items():
        kind, why = reason.split(": ", 1)
        assert kind in ("excluded", "counterpart") and len(why) > 10, key


def test_allowlist_entries_are_reached():
    """Every ALLOWLIST entry excuses something the walk of all the
    modules meets, and names its kind and a reason."""

    _check_allowlist()


@pytest.mark.parametrize("stale", [False, True],
                         ids=["native_name_absent", "stale_entry"])
def test_allowlist_without_native_library(monkeypatch, stale):
    """As where quakemigrate_tpu.core loaded no native library (no
    ``name`` left at module level): the walk and the reach check pass,
    and a stale entry still fails."""

    core = importlib.import_module("quakemigrate_tpu.core")
    monkeypatch.delattr(core, "name", raising=False)
    if not stale:
        _check_allowlist()
        return
    monkeypatch.setitem(ALLOWLIST, "quakemigrate_tpu.core.not_a_name",
                        "excluded: an entry that no module reaches")
    with pytest.raises(AssertionError, match="not_a_name"):
        _check_allowlist()
