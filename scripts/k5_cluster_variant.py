#!/usr/bin/env python3
"""Write a copy of the port whose K5 cluster route takes clusters of at most
S CTAs (``CL_SIZES`` in ``dealii_slod_tpu_torch/csrc/jacobi_eigh.cu`` cut
to the sizes <= S), so that ``chip_smoke.py`` times it beside the shipped
route on the same W and checks it the same way:

    python3 scripts/k5_cluster_variant.py 8            # -> _archive/k5_s8
    python3 chip_smoke.py --phases device,build,el-kernels --root _archive/k5_s8
    python3 chip_smoke.py --phases device,build,el-kernels

The copy goes to ``_archive/k5_s<S>`` (or the directory given second),
which ``.gitignore`` lists and ``chip_smoke.py --root`` accepts.
"""

import os
import re
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = re.compile(r"constexpr int CL_SIZES\[\] = \{([0-9, ]+)\};")


def main():
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    S = int(sys.argv[1])
    dest = os.path.abspath(sys.argv[2] if len(sys.argv) == 3 else
                           os.path.join(HERE, "_archive", f"k5_s{S}"))
    pkg = os.path.join(dest, "dealii_slod_tpu_torch")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "dealii_slod_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(pkg, "csrc", "jacobi_eigh.cu")
    with open(path) as fh:
        src = fh.read()
    m = SIZES.search(src)
    if m is None:
        raise SystemExit("k5_cluster_variant: CL_SIZES not in the source")
    keep = [s for s in (int(v) for v in m.group(1).split(",")) if s <= S]
    if not keep:
        raise SystemExit(f"k5_cluster_variant: no cluster size <= {S}")
    with open(path, "w") as fh:
        fh.write(src[:m.start(1)] + ", ".join(map(str, keep))
                 + src[m.end(1):])
    print(f"{os.path.relpath(dest, HERE)}: K5 cluster sizes {keep}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
