"""The import check: nothing JAX-side in the process, and nothing of the
program in the reference. Names are compared whole, by their top-level
part (before the first dot): ``gradtts_tpu_torch`` is not ``gradtts_tpu``.
"""

import ast
import glob
import os
import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'gradtts_tpu')
PROGRAM = 'gradtts_tpu_torch'
REFERENCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             'reference')


def top_level(name):
    return name.split('.')[0]


def forbidden_loaded(modules=None):
    """The forbidden top-level names among ``modules`` (default: every
    module the process has loaded)."""
    names = {top_level(n) for n in (sys.modules if modules is None
                                    else modules)}
    return sorted(names & set(FORBIDDEN))


def imported_names(path):
    """Top-level names that a Python file imports."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(top_level(node.module))
    return out


def reference_violations():
    """{file: names} of reference files that import the program or
    anything forbidden."""
    bad = {}
    for path in glob.glob(os.path.join(REFERENCE_DIR, '*.py')):
        names = imported_names(path) & (set(FORBIDDEN) | {PROGRAM})
        if names:
            bad[os.path.basename(path)] = sorted(names)
    return bad
