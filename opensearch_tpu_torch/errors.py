"""The port's errors: `NotPortedError` (its own), and copies of the
reference's cluster-state errors (opensearch_tpu/cluster/state.py), which
its client raises for a missing or an existing index."""


class NotPortedError(NotImplementedError):
    """A query kind, field type, analyzer, segment state or request option
    that this port does not serve yet. Raised instead of serving an answer
    that could differ from the reference's."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not ported to opensearch_tpu_torch yet")
        self.what = what


class ClusterStateError(Exception):
    pass


class IndexNotFoundError(ClusterStateError):
    """HTTP 404 analog."""


class ResourceAlreadyExistsError(ClusterStateError):
    """HTTP 400 analog of ResourceAlreadyExistsException."""
