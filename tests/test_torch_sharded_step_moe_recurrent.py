"""The sharded train step through DTensor, on the CPU: the MoE, recurrent
and encoder-decoder tiny archs (the others, and what is held, in
``test_torch_sharded_step.py``)."""
import pytest

from repro_torch.launch.mesh import run_ranks
from test_torch_sharded_step import check_arch, rank_body

ARCHS = ("grok-1-314b", "arctic-480b", "recurrentgemma-2b", "rwkv6-1.6b",
         "seamless-m4t-large-v2")


@pytest.fixture(scope="module")
def sharded():
    return run_ranks(rank_body, 4, backend="gloo", args=(ARCHS,),
                     timeout=600)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_on_a_2x2_mesh(sharded, arch):
    check_arch(sharded, arch)
