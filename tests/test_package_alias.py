"""The package's former name still imports, as the very same modules."""
import importlib
from pathlib import Path

import pytest

import altro_jax


def _former_name() -> str:
    """The one other `altro_*` package beside `altro_jax` in the checkout."""
    root = Path(__file__).resolve().parents[1]
    names = [
        p.name for p in root.glob("altro_*")
        if (p / "__init__.py").exists() and p.name != altro_jax.__name__
    ]
    assert len(names) == 1, names
    return names[0]


def test_former_name_reexports_public_api():
    alias = importlib.import_module(_former_name())
    for name in altro_jax.__all__:
        assert getattr(alias, name) is getattr(altro_jax, name), name


@pytest.mark.parametrize(
    "sub", [".solver.batched", ".models.problems", ".ops.forward_pallas"]
)
def test_former_name_submodules_are_altro_jax_modules(sub):
    module = importlib.import_module(_former_name() + sub)
    real = importlib.import_module(altro_jax.__name__ + sub)
    assert module is real
    # the module keeps its own import identity
    assert real.__spec__.name == altro_jax.__name__ + sub
