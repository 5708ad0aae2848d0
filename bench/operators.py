"""The benchmark's operators: frozen numpy copies of the port's generators.

Each generator (``bench/generators/<name>.py``) returns the CSR arrays
``(indptr int32, indices int32, data float64)``, ``np.array_equal`` to
what the port's ``repro_torch.sparse.problems`` builds for the same
problem today (a test holds them to it at small sizes).  They are copies,
not imports, so that a later change to the program's generators cannot
move the yardstick.  They and this module import numpy and the standard
library alone: the reference and the harness share them.

A configuration file names its generator (``"operator"``: the file
``bench/generators/<operator>.py``) and its parameters
(``"operator_args"``); :func:`load` builds the arrays once and keeps them
under ``build/bench/operators/`` inside the checkout, at a path fixed by
the parameters, so that later runs read them back instead of building
them.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench" / "operators"
GENERATORS = pathlib.Path(__file__).resolve().parent / "generators"


def csr_from_coo(rows, cols, vals, n):
    """Rows sorted stably (entries of a row keep their COO order)."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return indptr.astype(np.int32), cols.astype(np.int32), vals


def generate(config: dict):
    """The configuration's CSR arrays, built now by its generator,
    ``bench/generators/<operator>.py``'s ``generate(**operator_args)``."""
    path = GENERATORS / f"{config['operator']}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_generator_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.generate(**config["operator_args"])


def load(config: dict):
    """The configuration's CSR arrays, from the cache inside the checkout
    where an earlier run left them, else built and left there."""
    key = json.dumps([config["operator"], config["operator_args"]],
                     sort_keys=True)
    d = CACHE / (config["operator"] + "-"
                 + hashlib.sha1(key.encode()).hexdigest()[:16])
    names = ("indptr", "indices", "data")
    if all((d / f"{k}.npy").exists() for k in names):
        return tuple(np.load(d / f"{k}.npy") for k in names)
    arrays = generate(config)
    d.mkdir(parents=True, exist_ok=True)
    for k, a in zip(names, arrays):
        tmp = d / f"{k}.{os.getpid()}.npy"
        np.save(tmp, a)
        os.replace(tmp, d / f"{k}.npy")        # no half-written array
    return arrays
