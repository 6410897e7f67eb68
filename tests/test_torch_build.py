"""PyTorch port: the kernel libraries' C bindings and sources, without a
card.

The wrappers call each library's ``extern "C"`` launchers through
``ctypes`` with the argument types of ``build.SIGNATURES``, and ctypes
passes whatever it is given: a launcher whose parameters differ from its
declared types reads its arguments out of place on the card, where nothing
checks them.  These tests read the launchers' parameter lists from
``zerocaf_tpu_torch/csrc/*.cu`` and hold ``SIGNATURES`` against them, and
check that the sources include only headers of ``csrc``.  The tests marked
``cuda`` launch every wrapper on the card."""

import ctypes
import re

from zerocaf_tpu_torch.ops.kernels import build

KIND = {ctypes.c_void_p: "ptr", ctypes.c_int: "int"}


def _launchers(stem: str) -> dict[str, list[str]]:
    """The ``extern "C"`` launchers of ``csrc/<stem>.cu``: name -> the kind
    of each parameter, "ptr", "int" or "stream" (the last, a ``void*``)."""
    src = (build.CSRC / f"{stem}.cu").read_text()
    block = src[src.index('extern "C" {'):]
    found = {}
    for m in re.finditer(r"\bint\s+(zc_\w+)\s*\(([^)]*)\)\s*\{", block):
        decls = [" ".join(p.split()) for p in m.group(2).split(",")]
        assert decls[-1] == "void* stream", f"{m.group(1)}: stream not last"
        kinds = []
        for decl in decls:
            assert "*" in decl or re.fullmatch(r"int \w+", decl), \
                f"{m.group(1)}: parameter {decl!r} is neither a pointer nor an int"
            kinds.append("ptr" if "*" in decl else "int")
        found[m.group(1)] = kinds
    return found


def test_signatures_match_the_sources():
    """SIGNATURES names exactly the libraries that the sources build and
    exactly the launchers of each, and gives each launcher its parameters'
    kinds one for one, the last the stream that ``build.launch`` appends."""
    assert set(build.library_paths()) == set(build.SIGNATURES)
    for stem, fns in build.SIGNATURES.items():
        declared = {fn: [KIND[t] for t in types] for fn, types in fns.items()}
        assert declared == _launchers(stem), stem


def test_sources_include_only_headers_of_csrc():
    """Every quoted include names a file of csrc, and every header there is
    reached from a library's source (nothing stale compiles unread)."""
    files = {f.name: f.read_text() for f in build.sources()}
    incs = {name: re.findall(r'#include\s+"([^"]+)"', text)
            for name, text in files.items()}
    for name, names in incs.items():
        missing = set(names) - set(files)
        assert not missing, f"{name} includes {sorted(missing)}"
    reached, todo = set(), [n for n in files if n.endswith(".cu")]
    while todo:
        name = todo.pop()
        if name not in reached:
            reached.add(name)
            todo.extend(incs[name])
    assert reached == set(files)
