"""Text utilities: the port of ``mxnet_tpu/contrib/text/``'s vocabulary
(``Vocabulary``), which ``gluon.contrib.data.text`` indexes its corpora
with. The pretrained embeddings and ``utils`` are not ported yet."""
from . import vocab  # noqa: F401
from .vocab import Vocabulary  # noqa: F401

__all__ = ["vocab", "Vocabulary"]
