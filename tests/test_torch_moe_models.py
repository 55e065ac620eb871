"""The MoE archs (the reduced qwen2-moe-a2.7b and qwen3-moe-30b-a3b)
through tests/test_torch_models.py's parity: forward logits, the prefill's
caches and decode steps against the reference's, in float32 with the
reference's experts on every router call, in bfloat16 with them replayed
and the port's own routing held to the first-divergence rule (see that
module's docstring).  They run from this file of four items, so that
test_torch_models.py keeps its place in pytest-xdist's ``--dist
loadfile`` queue (ROADMAP queue 3).
"""

import pytest

from test_torch_models import MOE_ARCHS, hold_parity


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_prefill_decode_match_reference(arch, dtype):
    hold_parity(arch, dtype)
