"""Load one kernel module of several source trees side by side, for the
A/B tools (``tools/*_ab.py``).

``load_tree(name, src, module)`` copies ``src/one_peace_tpu_torch``'s
``csrc/``, ``ops/build.py`` and ``ops/<module>.py`` into
``build/ab/pkgs/<name>/`` as a package of that name and imports its
``ops.<module>``, so each tree builds and loads its own libraries.
"""

from __future__ import annotations

import importlib
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKGS = ROOT / "build" / "ab" / "pkgs"


def log(msg: str) -> None:
    print(msg, flush=True)


def load_tree(name: str, src: Path, module: str):
    """Copy the tree's ``ops/<module>.py``, builder and kernel sources into a
    package called ``name`` and import its ``ops.<module>``."""
    dst = PKGS / name
    if dst.exists():
        shutil.rmtree(dst)
    (dst / "ops").mkdir(parents=True)
    pkg = src / "one_peace_tpu_torch"
    shutil.copytree(pkg / "csrc", dst / "csrc")
    for f in ("build.py", f"{module}.py"):
        shutil.copy(pkg / "ops" / f, dst / "ops" / f)
    (dst / "__init__.py").write_text("")
    (dst / "ops" / "__init__.py").write_text("")
    if str(PKGS) not in sys.path:
        sys.path.insert(0, str(PKGS))
    return importlib.import_module(f"{name}.ops.{module}")
