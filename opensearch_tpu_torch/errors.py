"""Errors of the port's own (no counterpart in opensearch_tpu)."""


class NotPortedError(NotImplementedError):
    """A query kind, field type, analyzer, segment state or request option
    that this port does not serve yet. Raised instead of serving an answer
    that could differ from the reference's."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not ported to opensearch_tpu_torch yet")
        self.what = what
