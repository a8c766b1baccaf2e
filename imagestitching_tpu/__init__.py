"""Former name of the :mod:`imagestitching` package, kept as an import alias.

``import <this package>.X`` yields the module ``imagestitching.X`` itself —
one module object under two names, so classes and exceptions compare equal
whichever name imported them — and ``python -m <this package>.cli`` runs
``imagestitching.cli``.  New code imports ``imagestitching``.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import imagestitching as _target

_PREFIX = __name__ + "."


def _real_name(fullname: str) -> str:
    return _target.__name__ + "." + fullname[len(_PREFIX):]


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves every submodule of this package to the renamed module."""

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(_PREFIX):
            return None
        real = importlib.util.find_spec(_real_name(fullname))
        if real is None:
            return None
        return importlib.util.spec_from_loader(
            fullname, self,
            is_package=real.submodule_search_locations is not None)

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        # the import system returns whatever sys.modules holds afterwards
        sys.modules[module.__name__] = importlib.import_module(
            _real_name(module.__name__))

    def get_code(self, fullname):          # for ``python -m``
        real = importlib.util.find_spec(_real_name(fullname))
        return real.loader.get_code(real.name)


if not any(isinstance(f, _AliasFinder) for f in sys.meta_path):
    sys.meta_path.insert(0, _AliasFinder())

__all__ = _target.__all__
__version__ = _target.__version__


def __getattr__(name):
    return getattr(_target, name)
