"""Typed error for corrupt or unsupported compressed input."""


class DeflateError(ValueError):
    pass
