"""the percolator (`percolator` fields, the percolate query, `_percolator_document_slot`) in the port against the JAX package on the CPU.

Every case of the reference's tests/test_percolator.py runs as it is written there,
its `RestClient` replaced by `tests.test_torch_nested.Twin`: each call
goes to both packages' clients (the port's on `device="cpu"`), the
responses must be equal with `took` aside (scores within 1e-6 relative),
or both raise the same error, and the case's own assertions read the
port's response.
"""

import jax
import pytest

from tests.test_torch_nested import reference_cases, run_reference_case

jax.config.update("jax_platforms", "cpu")

CASES = reference_cases("test_percolator.py")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case(case, tmp_path):
    run_reference_case(case, tmp_path)
