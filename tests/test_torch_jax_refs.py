"""The store of JAX references that the port's tests read
(tests/jax_refs/, written by ``python tests/torch_jax_reference.py
--write``): the manifest against this tree, a live recomputation of the
cheapest entry of each kind, and (slow) a rewrite of the whole store held
to the committed one."""

import importlib
import json
import os

import numpy as np
import pytest

import torch_jax_reference as tjr

# The cheapest entry of each kind that computes from its seeded inputs
# alone, or from the stored entries it needs (a V-cycle from the stored
# levels), by the seconds the manifest records: the lean 16^2 k=1 fine
# level, the damped block-Jacobi V-cycle over the full 16^2 / 8^2
# levels, and the 8^2 k=0 HHO Poisson solve.
CHEAPEST = {"level": ("test_torch_lean", "level"),
            "vcycle": ("test_torch_multigrid", "damped_vcycle[block_jacobi]"),
            "solve": ("test_torch_poisson", "solution[0]")}
MAX_STORE_BYTES = 10 * 2 ** 20


def _same(path, a, b, rtol=1e-12):
    """a equals the stored b: strings, integers and booleans exactly,
    floats to ``rtol`` of b's largest entry (NaNs where b has them)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (path, a.shape, a.dtype, b.shape, b.dtype)
    if a.dtype.kind != "f":
        assert np.array_equal(a, b), path
        return
    nan = np.isnan(b)
    assert np.array_equal(np.isnan(a), nan), path
    if nan.all():
        return
    err = np.max(np.abs(a[~nan] - b[~nan]), initial=0.0)
    assert err <= rtol * np.max(np.abs(b[~nan]), initial=0.0), (path, err)


def _same_entry(flat, module, key, store=tjr.STORE):
    """The flattened fields of a recomputed entry against the stored
    ones."""
    fields = tjr.check_module(module, store)["entries"][key]["fields"]
    assert [p for p, _ in flat] == list(fields), (module, key)
    data = tjr._arrays(module, store)
    for path, a in flat:
        assert (a is None) == (fields[path] is None), (module, key, path)
        if a is not None:
            _same(f"{module} {key} {path}", a, data[f"{key}|{path}"])


def test_manifest_matches_tree():
    """Every module that declares stored references has them, made from
    this tree's JAX sources with its jax, jaxlib and numpy: the same
    entries as it declares, each field in the npz with the dtype and
    shape the manifest records. The store holds npz and JSON only, no
    pickle, at most 10 MB."""
    with open(os.path.join(tjr.STORE, "manifest.json")) as f:
        manifest = json.load(f)
    modules = tjr.stored_modules()
    assert sorted(manifest["modules"]) == modules
    assert manifest["command"] == tjr.COMMAND
    files = sorted(os.listdir(tjr.STORE))
    assert files == sorted(["manifest.json"] + [f"{m}.npz" for m in modules])
    assert sum(os.path.getsize(os.path.join(tjr.STORE, f))
               for f in files) <= MAX_STORE_BYTES
    for m in modules:
        section = tjr.check_module(m)
        assert list(section["entries"]) == \
            list(importlib.import_module(m).REFS.entries), m
        data = tjr._arrays(m)
        names = set()
        for key, entry in section["entries"].items():
            for path, spec in entry["fields"].items():
                if spec is None:
                    continue
                a = data[f"{key}|{path}"]
                assert [a.dtype.str, list(a.shape)] == spec, (m, key, path)
                names.add(f"{key}|{path}")
        assert names == set(data), m


def test_stale_store_raises(monkeypatch):
    """A store made from other JAX sources is refused, with the command
    that regenerates it; so is an entry the store lacks."""
    monkeypatch.setattr(tjr, "source_sha256", lambda: "0" * 64)
    with pytest.raises(tjr.StaleStore, match=tjr.COMMAND):
        tjr.jax_ref("test_torch_lean", "level")
    monkeypatch.undo()
    with pytest.raises(tjr.StaleStore, match=f"{tjr.COMMAND} test_torch_lean"):
        tjr.jax_ref("test_torch_lean", "no such entry")


@pytest.fixture(scope="module")
def recomputed(tmp_path_factory):
    """The CHEAPEST entries computed again now by the JAX package, each in
    a process set up as the store's writer is (XLA on one thread, its
    transfer builders memoized)."""
    return tjr.recompute(CHEAPEST.values(),
                         str(tmp_path_factory.mktemp("recomputed")))


@pytest.mark.parametrize("kind", sorted(CHEAPEST))
def test_cheapest_entry_recomputes(kind, recomputed):
    """The cheapest stored level, V-cycle apply and solve, computed again
    now, equal the store to 1e-12 relative."""
    module, key = CHEAPEST[kind]
    assert importlib.import_module(module).REFS.entries[key].kind == kind
    _same_entry(recomputed[(module, key)], module, key)


@pytest.mark.slow
def test_store_regenerates(tmp_path):
    """The whole store written anew into a temporary directory (one
    process per module, XLA on one thread) equals the committed one,
    entry by entry, to 1e-12 relative."""
    modules = tjr.stored_modules()
    tjr.write(modules, str(tmp_path), jobs=4)
    for m in modules:
        section = tjr.check_module(m, str(tmp_path))
        assert section["entries"].keys() == \
            tjr.check_module(m)["entries"].keys(), m
        fresh = tjr._arrays(m, str(tmp_path))
        for key, entry in section["entries"].items():
            flat = [(p, None if spec is None else fresh[f"{key}|{p}"])
                    for p, spec in entry["fields"].items()]
            _same_entry(flat, m, key)
