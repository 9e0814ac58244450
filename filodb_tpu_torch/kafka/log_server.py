"""The log server's error type.

Of ``filodb_tpu/kafka/log_server.py`` only ``LogOpError`` (``:50``) is
here so far: a shard's ingest worker and a follower's tail count it
apart from a transport failure. The server itself, its client and the
networked log come with ROADMAP §A7.3.
"""

from __future__ import annotations


class LogOpError(RuntimeError):
    """A server-side ('err', ...) reply — deterministic, not a transport
    failure. Callers that retry transport errors (ConnectionError/OSError)
    must NOT retry these forever: the server will keep answering the same
    way (corrupt log file, rejected name, oversized read...)."""
