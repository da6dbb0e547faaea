"""Engine error types (reference: src/core/errors.ts)."""

from __future__ import annotations


class AccessControlError(Exception):
    code = 500


class InvalidRequest(AccessControlError):
    code = 400

    def __init__(self, detail: str = ""):
        super().__init__(f"Invalid request: {detail}")


class InvalidRequestContext(AccessControlError):
    code = 400

    def __init__(self, detail: str = ""):
        super().__init__(f"Invalid request context: {detail}")


class InvalidCombiningAlgorithm(AccessControlError):
    code = 500

    def __init__(self, urn: str = ""):
        super().__init__(f"Invalid combining algorithm: {urn}")
        self.urn = urn


class UnsupportedResourceAdapter(AccessControlError):
    code = 500

    def __init__(self, config=None):
        super().__init__(f"Unsupported resource adapter: {config}")


class UnexpectedContextQueryResponse(AccessControlError):
    code = 500

    def __init__(self, detail: str = ""):
        super().__init__(f"Unexpected context query response: {detail}")


class ContextQueryTransportError(AccessControlError):
    """Non-2xx HTTP response from a context-query endpoint.  Carries the
    upstream status as ``code`` so the engine's deny-on-error branch keeps
    the transport's classification (the old ``urllib.urlopen`` transport
    raised ``HTTPError`` with the same ``code`` here) instead of feeding
    an error body into GraphQL parsing."""

    def __init__(self, status: int, reason: str = ""):
        super().__init__(
            f"Context query endpoint returned {status} {reason}".rstrip()
        )
        self.code = int(status)


class ConditionEvaluationError(AccessControlError):
    """Raised when a rule condition fails to evaluate; the engine converts
    this into a deny-by-default response (reference:
    src/core/accessController.ts:259-270)."""

    code = 500
