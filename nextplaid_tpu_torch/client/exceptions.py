"""Client exception hierarchy (next-plaid python-sdk exceptions.py)."""


class NextPlaidClientError(Exception):
    """Base error; carries the HTTP status code when available."""

    def __init__(self, message: str, status_code=None):
        super().__init__(message)
        self.status_code = status_code


class ConnectionError_(NextPlaidClientError):
    pass


class IndexNotFoundError(NextPlaidClientError):
    pass


class IndexExistsError(NextPlaidClientError):
    pass


class ValidationError(NextPlaidClientError):
    pass


class ServerError(NextPlaidClientError):
    pass


def raise_for_status(status: int, message: str) -> None:
    if status == 404:
        raise IndexNotFoundError(message, status)
    if status == 409:
        raise IndexExistsError(message, status)
    if status in (400, 422):
        raise ValidationError(message, status)
    if status >= 500:
        raise ServerError(message, status)
    raise NextPlaidClientError(message, status)
