"""the parent-child join (`join` fields, has_child, has_parent, parent_id, their inner_hits) in the port against the JAX package on the CPU.

Every case of the reference's tests/test_join.py runs as it is written there,
its `RestClient` replaced by `tests.test_torch_nested.Twin`: each call
goes to both packages' clients (the port's on `device="cpu"`), the
responses must be equal with `took` aside (scores within 1e-6 relative),
or both raise the same error, and the case's own assertions read the
port's response. The reference's multi-shard case raises the port's
NotPortedError("number_of_shards > 1"), which it keeps.
"""

import jax
import pytest

from tests.test_torch_nested import reference_cases, run_reference_case

jax.config.update("jax_platforms", "cpu")

# an index of 4 shards (Queue 1 keeps one shard a index)
CASES = reference_cases("test_join.py", refused={
    "TestJoinMultiShard::test_routing_keeps_family_together":
        "number_of_shards"})


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case(case, tmp_path):
    run_reference_case(case, tmp_path)
