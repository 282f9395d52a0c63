"""Tests of the torch port that need a CUDA card (marked ``gpu``).

Where there is no card the ``cuda`` fixture skips them.  On the card,
without JAX (tests/conftest.py imports it):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

They check kernel K1 against its plain PyTorch version at TPC-H Q1's
shapes and at edge cases (exact equality), among them every case of
``K1_CASES`` (``datafusion_tpu_torch/ops/smalldomain_cases.py``, which
``chip_smoke.py`` runs too); Q1 on the card against Q1 on the CPU; and
that Q1 on the card launched K1.
"""

import numpy as np
import pytest
import torch

from datafusion_tpu_torch import ExecutionContext
from datafusion_tpu_torch.ops import smalldomain as SD
from datafusion_tpu_torch.ops.smalldomain_cases import K1_CASES
from datafusion_tpu_torch.q1data import generate_lineitem_q1
from datafusion_tpu_torch.queries import get_query_sql


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, n, domain, k, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    gid = rng.integers(-1, domain + 1, n).astype(np.int32)  # -1, domain: dead
    cols = [torch.from_numpy(rng.integers(lo, hi, n, dtype=np.int64)).to(dev) for _ in range(k)]
    masks = [torch.from_numpy(rng.random(n) > 0.1).to(dev) for _ in range(k)]
    if k > 1:
        cols[-1], masks[-1] = None, None  # count(*)
        masks[0] = None
    return torch.from_numpy(gid).to(dev), cols, masks


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,domain,k,lo,hi",
    [
        (8_388_608, 12, 8, 0, 10**9),  # Q1 at SF1
        (1 << 20, 256, 8, -(10**14), 10**14),
        (1 << 20, 5, 3, (1 << 62) - 1000, 1 << 62),  # wraps
        (1_000_003, 7, 4, -1000, 1000),  # not a multiple of the block
        (0, 4, 2, 0, 10),
    ],
)
def test_k1_kernel_equals_plain(cuda, n, domain, k, lo, hi):
    gid, cols, masks = _inputs(cuda, n, domain, k, lo, hi)
    before = SD.smalldomain_sum_count.launches
    s, c = SD.smalldomain_sum_count(gid, cols, masks, domain)
    torch.cuda.synchronize()
    ps, pc = SD.smalldomain_sum_count_plain(gid, cols, masks, domain)
    assert torch.equal(s, ps) and torch.equal(c, pc)
    assert SD.smalldomain_sum_count.launches == before + (1 if n else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(K1_CASES))
def test_k1_smoke_cases_equal_plain(cuda, name):
    args = K1_CASES[name](np.random.default_rng(1))
    before = SD.smalldomain_sum_count.launches
    s, c = SD.smalldomain_sum_count(*args)
    torch.cuda.synchronize()
    ps, pc = SD.smalldomain_sum_count_plain(*args)
    assert torch.equal(s, ps) and torch.equal(c, pc)
    assert SD.smalldomain_sum_count.launches == before + 1


@pytest.mark.gpu
def test_k1_all_dead(cuda):
    gid = torch.full((65_536,), 9, dtype=torch.int32, device=cuda)
    col = torch.ones(65_536, dtype=torch.int64, device=cuda)
    s, c = SD.smalldomain_sum_count(gid, [col], [None], 4)
    assert int(s.abs().sum()) == 0 and int(c.sum()) == 0


@pytest.mark.gpu
def test_k1_refuses_what_it_does_not_take(cuda):
    gid, cols, masks = _inputs(cuda, 1000, 300, 2, 0, 10)
    with pytest.raises(ValueError):
        SD.smalldomain_sum_count(gid, cols, masks, 300)  # domain > 256
    with pytest.raises(ValueError):
        SD.smalldomain_sum_count(gid.long(), cols, masks, 4)  # int64 gid
    with pytest.raises(ValueError):
        SD.smalldomain_sum_count(gid, [cols[0]] * 9, [None] * 9, 4)  # k > 8
    with pytest.raises(ValueError):
        SD.smalldomain_sum_count(gid, [cols[0][:500]], [None], 4)  # wrong length
    with pytest.raises(ValueError):
        strided = torch.stack([cols[0], cols[0]], dim=1)[:, 0]
        SD.smalldomain_sum_count(gid, [strided], [None], 4)  # not contiguous


@pytest.mark.gpu
def test_q1_on_card_matches_cpu_and_launches_k1(cuda):
    sql = get_query_sql(1)
    cpu = ExecutionContext(device="cpu")
    cpu.register_table("lineitem", generate_lineitem_q1(0.01, device="cpu"))
    gpu = ExecutionContext()  # device=None: the card
    assert gpu.device.type == "cuda"
    gpu.register_table("lineitem", generate_lineitem_q1(0.01))
    SD.smalldomain_sum_count.launches = 0
    got = gpu.sql(sql).collect().to_pydict()
    assert SD.smalldomain_sum_count.launches > 0
    assert got == cpu.sql(sql).collect().to_pydict()
