"""The benchmark's own CPU tests: ``python -m pytest gsbench/tests`` from the
root of the repository. They put the checkout root and ``src`` on the path,
as ``gsbench/run.py`` does, and shrink a cell to a size the CPU can hold."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


# the 2048-px cell keeps more of its frame on the CPU: at 256 px its 16 x 16
# tiles fill 4 superblocks, and with blocks of ``BLOCKED`` tiles the
# reference composites that frame in 4 passes, as the cell's own takes 16
CPU_SIZES = {"ks4m-train-2048": {"res": 256}}
BLOCKED = 64


def shrink(cell: dict, *, binning: str = "hier", k: int = 16, res: int = 64) -> dict:
    """A cell cut to a few thousand Gaussians, 8 views of ``res`` px and a
    batch of 2, its limits kept: what a CPU test can run in seconds."""
    c = cell["config_data"]
    c.update(n_gaussians=3000, views=8)
    c["volume"]["res"] = 24
    c["gs"].update(k_per_tile=k, binning=binning)
    cell["traffic_data"].update(res=res, batch=2, profile_steps=2)
    return cell


@pytest.fixture
def tiny():
    from gsbench.harness import load_cell

    return lambda name, **kw: shrink(load_cell(name), **{**CPU_SIZES.get(name, {}), **kw})
