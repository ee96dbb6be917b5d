"""RawJpeg marker type: undecoded JPEG bytes flowing through the pipeline
to the native decode path (data/native.py)."""


class RawJpeg(bytes):
    """JPEG file contents; transforms decode via the native library."""
    __slots__ = ()
