"""The package's former name, kept so existing imports keep working.

Every module is the `altro_jax` module itself (same objects, same classes),
reached under this name: `import <this>.solver.batched` returns
`altro_jax.solver.batched`.  New code imports `altro_jax`.
"""
import importlib
import importlib.abc
import importlib.util
import sys

import altro_jax
from altro_jax import *  # noqa: F401,F403
from altro_jax import __all__  # noqa: F401

_TARGET = altro_jax.__name__
_PREFIX = __name__ + "."


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves `<this>.x.y` to the already-importable `altro_jax.x.y`."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(_PREFIX):
            return None
        return importlib.util.spec_from_loader(fullname, self)

    def create_module(self, spec):
        module = importlib.import_module(_TARGET + spec.name[len(__name__):])
        # the import system overwrites __spec__ with the alias's; put the
        # module's own back in exec_module
        self._specs[module.__name__] = module.__spec__
        return module

    def exec_module(self, module):
        module.__spec__ = self._specs.pop(module.__name__)


sys.meta_path.insert(0, _Alias())
