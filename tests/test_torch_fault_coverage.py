"""Every fault site of the port is a real seam and is drilled by a test.

``resilience/faults.py`` ``SITES`` is the injection contract: a site that
no code fires is a spec that parses and tests nothing, and a site no test
names has an untested failure story.  For each site the port must hold a
``fault_point("<site>", ...)`` call in ``music_analyst_tpu_torch/`` and a
mention in a ``tests/test_torch_*.py`` file, unless the site is in the
named list below with its reason.  The port's sites must also be JAX's.
"""

import os
import re

from music_analyst_tpu.resilience.faults import SITES as JAX_SITES
from music_analyst_tpu_torch.resilience.faults import SITES

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THIS = os.path.basename(__file__)

# Sites whose code has no counterpart in the port, each with its reason.
NOT_IN_PORT = {
    # JAX fires it around its first lower-and-compile of a program
    # (``profiling/compile.py``); the port compiles no programs, and its
    # only builds are the kernels' nvcc runs (ROADMAP.md §1).
    "compile.first": "the port compiles no programs",
    # JAX fires it in its load generator (``benchmarks/loadgen.py``),
    # which is not part of either package and has no port.
    "loadgen.tick": "the load generator is a JAX benchmark, not ported",
}


def _sources(directory, prefix=""):
    chunks = {}
    for root, _, files in os.walk(directory):
        for name in sorted(files):
            if name.endswith(".py") and name.startswith(prefix):
                with open(os.path.join(root, name), encoding="utf-8") as fh:
                    chunks[os.path.join(root, name)] = fh.read()
    return chunks


def test_port_sites_are_jax_sites():
    assert SITES == JAX_SITES
    assert set(NOT_IN_PORT) <= SITES


def test_every_site_has_a_fault_point_in_the_port():
    code = "\n".join(_sources(os.path.join(_REPO, "music_analyst_tpu_torch"))
                     .values())
    fired = set(re.findall(r'fault_point\(\s*"([^"]+)"', code))
    assert fired <= SITES, f"fault_point at unknown sites: {fired - SITES}"
    missing = sorted(SITES - fired - set(NOT_IN_PORT))
    assert not missing, f"sites with no fault_point in the port: {missing}"
    # A listed exception must really have no seam; else it is stale.
    assert not fired & set(NOT_IN_PORT)


def test_every_site_is_named_in_a_port_test():
    tests = _sources(os.path.join(_REPO, "tests"), prefix="test_torch_")
    corpus = "\n".join(text for path, text in tests.items()
                       if os.path.basename(path) != _THIS)
    missing = sorted(site for site in SITES - set(NOT_IN_PORT)
                     if f'"{site}' not in corpus and f"'{site}" not in corpus)
    assert not missing, f"sites no port test drills: {missing}"
