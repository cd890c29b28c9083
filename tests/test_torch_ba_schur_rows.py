"""BA's float32 reduced system against the library's LU, over the rows of
`tools/torch_ba_schur_errors.py` (ROADMAP queue 3, repaired item: BA's
float32 S error).

For the 2-D model on the six cases the CPU runs (the card tests' orbit and
loop capacities, a point seen once, padding points, a frame without
observations, two observations of one point in one frame) at lam 0, 3e-5,
7.68e-3 and 1 (24 rows), the plain version's float32 error against float64
(`plain_cpu`) over the same with V inverted by `torch.linalg.inv`
(`plain_cpu_lu`, MKL's LU): the geometric mean over the rows of that ratio
is at most 1.10 for S, rhs_c, V^-1 and dp. A row's own ratio is a max over
rounding noise (0.3-3x, moved by a 1-ulp change in V^-1), and MKL's factors
are matched bit for bit only with fused multiply-adds, which elementwise
torch does not make; over the rows the written-out pivoted LU is as
accurate as the library's.

Torch is pinned to one intra-op thread while the module runs.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

CPU_CASES = ["orbit", "loop", "one_observation", "padding_points", "frame_without_observations", "two_in_one_frame"]
MAX_GEOMETRIC_MEAN = 1.10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_float32_error_against_the_library_lu_over_the_rows(capsys):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    import torch_ba_schur_errors as tool

    assert tool.main(["--device", "cpu", "--models", "2d", "--cases", *CPU_CASES]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 24 and {r["case"] for r in rows} == set(CPU_CASES)
    for q in ("S", "rhs_c", "Vinv", "dp"):
        ratios = np.array([r["plain_cpu"][q] / r["plain_cpu_lu"][q] for r in rows])
        assert np.all(np.isfinite(ratios) & (ratios > 0)), q
        mean = float(np.exp(np.mean(np.log(ratios))))
        assert mean <= MAX_GEOMETRIC_MEAN, (q, mean, ratios.round(2).tolist())
