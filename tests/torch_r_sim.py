"""The R runtime of the tests (``tests/r_interp.py``) bound to the port.

``TorchInterp`` runs the port's R package (``r/distributedtputorch/``) on
the simulated R interpreter and reticulate bridge of the reference's
tests: ``reticulate::import("distributed_tpu_torch")`` returns the port,
``library(distributedtputorch)`` loads the package's R sources, and
``options(...)``/``getOption(...)`` keep R's session options (the
examples read their device from ``distributedtputorch.device``: unset is
NULL, the GPU).

Free of JAX: it never imports ``jax`` or the JAX package, so
``chip_smoke.py`` drives the R examples on the card through it.
"""

from __future__ import annotations

import glob
import os
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
R_DIR = ROOT / "r" / "distributedtputorch" / "R"
EXAMPLES = ROOT / "r" / "distributedtputorch" / "examples"
PACKAGE = "distributedtputorch"
DEVICE_OPTION = "distributedtputorch.device"

if str(TESTS) not in sys.path:  # r_interp's own imports are top-level
    sys.path.insert(0, str(TESTS))

import r_lang as L  # noqa: E402
from r_interp import NULL, REnv, RError, RFunction, RProxy, Interp  # noqa: E402
from reticulate_sim import RVector, r_character  # noqa: E402
from r_interp import _scalar  # noqa: E402


class TorchInterp(Interp):
    """The simulated R session with the port as its Python side.
    ``device``: the session's ``distributedtputorch.device`` option
    (None leaves it unset: the GPU)."""

    def __init__(self, device=None, r_dir=R_DIR):
        import distributed_tpu_torch

        self.r_options = {}
        super().__init__(bridge_module=distributed_tpu_torch,
                         r_dir=str(r_dir))
        if device is not None:
            self.r_options[DEVICE_OPTION] = r_character(str(device))

    def _install_base(self):
        super()._install_base()
        b = self.builtins_env

        def options(**kwargs):
            old = {k: self.r_options.get(k, NULL) for k in kwargs}
            self.r_options.update(kwargs)
            return old

        b.define("options", options)
        b.define("getOption", lambda x, default=NULL: self.r_options.get(
            _scalar(x), default))

    def _install_namespaces(self):
        super()._install_namespaces()

        def import_py(module, **kwargs):
            name = _scalar(module)
            if name == "distributed_tpu_torch":
                return RProxy(self.bridge_module)
            raise RError(f"reticulate cannot import {name!r} in the sim")

        self.namespaces["reticulate"]["import"] = import_py

    def _r_library(self, pkg, **kwargs):
        name = _scalar(pkg) if isinstance(pkg, RVector) else None
        if name == "distributedtpu":  # the reference's package: not here
            raise RError("there is no package called 'distributedtpu'")
        if name != PACKAGE:
            return super()._r_library(pkg, **kwargs)
        if PACKAGE in self.loaded_packages:
            return NULL
        pkg_env = REnv(parent=self.global_env, name=f"pkg:{PACKAGE}")
        for path in sorted(glob.glob(os.path.join(self.r_dir, "*.R"))):
            self.eval_program(L.parse_file(path), pkg_env)
        # Attach every top-level binding, as the reference's loader does.
        for k, v in pkg_env.vars.items():
            if k != ".onLoad":
                self.global_env.define(k, v)
        onload = pkg_env.vars.get(".onLoad")
        if isinstance(onload, RFunction):
            self.call_function(
                onload,
                [(None, self.value_promise(r_character("lib"))),
                 (None, self.value_promise(r_character(PACKAGE)))],
                self.global_env,
            )
        self.loaded_packages.add(PACKAGE)
        return NULL


def run_example(name: str, device=None, source=None) -> TorchInterp:
    """Run ``r/distributedtputorch/examples/<name>.R`` (or ``source``, its
    text rewritten) in a fresh session on ``device``; returns the session."""
    interp = TorchInterp(device=device)
    if source is None:
        interp.run_file(EXAMPLES / f"{name}.R")
    else:
        interp.run_source(source)
    return interp


__all__ = ["DEVICE_OPTION", "EXAMPLES", "PACKAGE", "R_DIR", "TorchInterp",
           "run_example"]
