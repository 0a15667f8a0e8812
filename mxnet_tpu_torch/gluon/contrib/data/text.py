"""Language-modelling text datasets: the port of
``mxnet_tpu/gluon/contrib/data/text.py`` (``CorpusDataset``,
``WikiText2`` and ``WikiText103``), on local files only: a WikiText set
reads ``wiki.{train,valid,test}.tokens`` under ``root`` and raises when
the file is not there. A sample is ``(data, label)``, two int32 host
NDArrays of ``seq_len`` token ids, the label shifted by one token."""
from __future__ import annotations

import io
import os
from collections import Counter

import numpy as np

from ....base import MXNetError
from ....context import cpu
from ...data.dataset import Dataset

__all__ = ["CorpusDataset", "WikiText2", "WikiText103"]


class CorpusDataset(Dataset):
    """Fixed-length samples of a whitespace-tokenized text file: each
    line's tokens (with ``bos``/``eos`` around it) in order, indexed by
    ``vocab`` (built from the file's counts when not given)."""

    def __init__(self, filename, seq_len=35, bos=None, eos="<eos>",
                 vocab=None, encoding="utf-8"):
        from ....contrib.text import Vocabulary

        self._seq_len = seq_len
        with io.open(filename, "r", encoding=encoding) as f:
            raw = f.read()
        tokens = []
        for line in raw.split("\n"):
            line = line.split()
            if not line:
                continue
            if bos is not None:
                tokens.append(bos)
            tokens.extend(line)
            if eos is not None:
                tokens.append(eos)
        if vocab is None:
            vocab = Vocabulary(Counter(tokens), unknown_token="<unk>")
        self.vocabulary = vocab
        ids = np.asarray(vocab.to_indices(tokens), dtype=np.int32)
        n = (len(ids) - 1) // seq_len
        if n < 1:
            raise MXNetError("corpus too short for seq_len=%d" % seq_len)
        self._data = ids[: n * seq_len].reshape(n, seq_len)
        self._label = ids[1: n * seq_len + 1].reshape(n, seq_len)

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        from .... import ndarray as nd

        return (nd.array(self._data[idx], ctx=cpu()),
                nd.array(self._label[idx], ctx=cpu()))


class _WikiText(CorpusDataset):
    _namespace = None
    _segment_files = {"train": "wiki.train.tokens",
                      "val": "wiki.valid.tokens",
                      "test": "wiki.test.tokens"}

    def __init__(self, root, segment, seq_len, vocab):
        fname = os.path.join(os.path.expanduser(root),
                             self._segment_files[segment])
        if not os.path.isfile(fname):
            raise MXNetError(
                "%s not found at %s: nothing is downloaded; extract the %s "
                "archive into %r" % (self._segment_files[segment], fname,
                                     self._namespace, root))
        super().__init__(fname, seq_len=seq_len, vocab=vocab)


class WikiText2(_WikiText):
    """WikiText-2, from local files."""

    _namespace = "wikitext-2"

    def __init__(self, root="~/.mxnet/datasets/wikitext-2", segment="train",
                 seq_len=35, vocab=None):
        super().__init__(root, segment, seq_len, vocab)


class WikiText103(_WikiText):
    """WikiText-103, from local files."""

    _namespace = "wikitext-103"

    def __init__(self, root="~/.mxnet/datasets/wikitext-103",
                 segment="train", seq_len=35, vocab=None):
        super().__init__(root, segment, seq_len, vocab)
