"""Token indexing: the port of ``mxnet_tpu/contrib/text/vocab.py``
(reference ``python/mxnet/contrib/text/vocab.py``)."""
from __future__ import annotations

from collections import Counter
from typing import List, Optional, Sequence, Union

from ...base import MXNetError

__all__ = ["Vocabulary"]


class Vocabulary(object):
    """Token <-> index mapping built from a frequency counter.

    Index 0 is the unknown token (when set); the reserved tokens follow,
    then the counter's keys by falling frequency (ties alphabetical),
    at most ``most_freq_count`` of them and none below ``min_freq``."""

    def __init__(self, counter: Optional[Counter] = None,
                 most_freq_count: Optional[int] = None, min_freq: int = 1,
                 unknown_token: str = "<unk>",
                 reserved_tokens: Optional[Sequence[str]] = None):
        if min_freq < 1:
            raise MXNetError("min_freq must be >= 1")
        if reserved_tokens is not None:
            rset = set(reserved_tokens)
            if len(rset) != len(reserved_tokens):
                raise MXNetError("reserved_tokens may not contain duplicates")
            if unknown_token in rset:
                raise MXNetError("reserved_tokens must not contain the "
                                 "unknown token")
        self._unknown_token = unknown_token
        self._reserved_tokens = list(reserved_tokens) if reserved_tokens \
            else None
        self._idx_to_token: List[str] = []
        if unknown_token is not None:
            self._idx_to_token.append(unknown_token)
        if reserved_tokens:
            self._idx_to_token.extend(reserved_tokens)
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            self._index_counter_keys(counter, most_freq_count, min_freq)

    def _index_counter_keys(self, counter, most_freq_count, min_freq):
        existing = set(self._idx_to_token)
        taken = 0
        for token, freq in sorted(counter.items(),
                                  key=lambda kv: (-kv[1], kv[0])):
            if freq < min_freq:
                break
            if most_freq_count is not None and taken >= most_freq_count:
                break
            taken += 1  # the cap counts keys, collisions included
            if token in existing:
                continue
            self._token_to_idx[token] = len(self._idx_to_token)
            self._idx_to_token.append(token)

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens: Union[str, Sequence[str]]):
        """The index of a token, or the list of indices of a list; an
        unknown token maps to the unknown index (raises without one)."""
        single = isinstance(tokens, str)
        out = []
        for t in [tokens] if single else list(tokens):
            if t in self._token_to_idx:
                out.append(self._token_to_idx[t])
            elif self._unknown_token is not None:
                out.append(self._token_to_idx[self._unknown_token])
            else:
                raise MXNetError("token %r is unknown and no unknown_token "
                                 "is set" % t)
        return out[0] if single else out

    def to_tokens(self, indices: Union[int, Sequence[int]]):
        single = isinstance(indices, int)
        out = []
        for i in [indices] if single else list(indices):
            if not 0 <= i < len(self._idx_to_token):
                raise MXNetError("token index %d out of range [0, %d)"
                                 % (i, len(self._idx_to_token)))
            out.append(self._idx_to_token[i])
        return out[0] if single else out
