"""Compare the machine code (SASS) of two builds of a CUDA library,
instance by instance.  Instances whose normalised name matches
``--changed`` (a regular expression) are the ones an edit meant to
change: they are listed apart and left out of the verdict.

    python -m mpi_tpu_torch.tools.sass_compare [--changed REGEX] OLD.so NEW.so [OLD.so NEW.so ...]

Each library is read with ``cuobjdump -sass`` (the CUDA toolkit's, on the
machine with the card).  Function names are normalised first: a kernel in
an anonymous namespace carries a hash of its file in its name, so two
builds of an edited source name the same instance apart.  Address comments
are dropped, the instructions compared.  Prints, per pair, the instances of
each build and how many have identical instructions; exits 1 unless every
instance of every pair is identical (an edit that only moves code between
a source and its headers keeps them so).
"""

from __future__ import annotations

import re
import subprocess
import sys
from typing import Dict, List

_FUNCTION = re.compile(r"Function : (\S+)")
_ANONYMOUS = re.compile(r"(\d+)_GLOBAL__N__")
_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*/\*")


def _normalise(name: str) -> str:
    """The mangled name with its anonymous namespace (an identifier whose
    length the mangling writes before it) replaced by ``<anonymous>``."""
    m = _ANONYMOUS.search(name)
    if m is None:
        return name
    return name[:m.start()] + "<anonymous>" + name[m.end(1) + int(m.group(1)):]


def parse(sass: str) -> Dict[str, List[str]]:
    """``cuobjdump -sass`` text -> {normalised function name: instructions}."""
    funcs: Dict[str, List[str]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            cur = _normalise(m.group(1))
            funcs[cur] = []
            continue
        m = _INSTRUCTION.match(line)
        if m and cur is not None:
            funcs[cur].append(m.group(1))
    return funcs


def compare(old: str, new: str, changed: str = None) -> Dict[str, object]:
    a, b = (parse(subprocess.run(["cuobjdump", "-sass", path], capture_output=True,
                                 text=True, check=True).stdout) for path in (old, new))
    moved = sorted(f for f in set(a) | set(b) if changed and re.search(changed, f))
    a, b = ({f: v for f, v in x.items() if f not in moved} for x in (a, b))
    return {"old": len(a), "new": len(b),
            "identical": sum(a[f] == b.get(f) for f in a),
            "instructions": sum(len(v) for v in a.values()), "changed": moved}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    changed = None
    if args[:1] == ["--changed"]:
        changed, args = args[1], args[2:]
    if not args or len(args) % 2:
        print(__doc__, file=sys.stderr)
        return 2
    same = True
    for old, new in zip(args[::2], args[1::2]):
        r = compare(old, new, changed)
        print(f"{old} -> {new}: {r['old']} instances, {r['new']} in the new build, "
              f"{r['identical']} with identical SASS ({r['instructions']} instructions)"
              + (f"; {len(r['changed'])} meant to change: {r['changed']}" if r["changed"] else ""))
        same &= r["identical"] == r["old"] == r["new"]
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
