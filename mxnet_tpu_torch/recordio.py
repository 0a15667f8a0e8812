"""RecordIO: the reference's binary record format, byte-compatible; the
port of ``mxnet_tpu/recordio.py``.

Each record is ``uint32 magic (0xced7230a) | uint32 lrec | payload |
pad to 4``; lrec's upper 3 bits are the continuation flag (0 = whole
record) and its lower 29 bits the payload length. A payload that embeds
the magic word is split there on write (flags 1/2/3) and joined with it
on read, as dmlc-core does. So a ``.rec`` written by the JAX package (or
by MXNet's ``im2rec``) reads here and the other way round. The JAX
package's native C++ reader is not carried over: this is its pure-Python
path.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", _MAGIC)
_LREC_FLAG_BITS = 29
_LREC_MASK = (1 << _LREC_FLAG_BITS) - 1


class MXRecordIO(object):
    """Sequential .rec reader (``flag='r'``) or writer (``'w'``)
    (reference recordio.py:36)."""

    fid = None  # until open(): the destructor may run before it

    def __init__(self, uri, flag):
        if flag not in ("r", "w"):
            raise MXNetError("Invalid flag %s" % flag)
        self.uri = uri
        self.flag = flag
        self.writable = flag == "w"
        self.open()

    def open(self):
        self.fid = open(self.uri, "wb" if self.writable else "rb")

    def close(self):
        if self.fid is not None and not self.fid.closed:
            self.fid.close()
        self.fid = None

    def __del__(self):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        """Write one record."""
        if not self.writable:
            raise MXNetError("write on a reader")
        if len(buf) > _LREC_MASK:
            raise MXNetError("RecordIO record too large: %d bytes (max %d)"
                             % (len(buf), _LREC_MASK))
        parts = bytes(buf).split(_MAGIC_BYTES)
        for i, part in enumerate(parts):
            if len(parts) == 1:
                cflag = 0
            elif i == 0:
                cflag = 1
            elif i == len(parts) - 1:
                cflag = 3
            else:
                cflag = 2
            lrec = (cflag << _LREC_FLAG_BITS) | len(part)
            self.fid.write(struct.pack("<II", _MAGIC, lrec))
            self.fid.write(part)
            self.fid.write(b"\x00" * ((4 - len(part) % 4) % 4))

    def _chunk(self):
        head = self.fid.read(8)
        if len(head) < 8:
            return None, None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise MXNetError("Invalid RecordIO magic 0x%x" % magic)
        length = lrec & _LREC_MASK
        payload = self.fid.read(length)
        self.fid.read((4 - length % 4) % 4)
        return lrec >> _LREC_FLAG_BITS, payload

    def read(self):
        """The next record, or None at the end."""
        if self.writable:
            raise MXNetError("read on a writer")
        cflag, payload = self._chunk()
        if cflag is None:
            return None
        chunks = [payload]
        while cflag in (1, 2):  # rejoin with the magic the writer cut
            cflag, payload = self._chunk()
            if cflag is None:
                raise MXNetError("RecordIO: truncated continuation record")
            chunks += [_MAGIC_BYTES, payload]
        return b"".join(chunks)

    def tell(self):
        return self.fid.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec with a .idx file of ``key\\toffset`` lines
    (reference recordio.py:170)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    fields = line.strip().split("\t")
                    key = self.key_type(fields[0])
                    self.idx[key] = int(fields[1])
                    self.keys.append(key)

    def close(self):
        if self.writable and self.fid is not None and not self.fid.closed:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        self.fid.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


# header (reference recordio.py:291): flag uint32, label float32 (flag > 0:
# that many float32 labels follow the header), id uint64, id2 uint64
IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """A header and a byte payload as one record."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        return struct.pack(_IR_FORMAT, *header._replace(flag=0)) + s
    label = np.asarray(header.label, dtype=np.float32)
    header = header._replace(flag=label.size, label=0)
    return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s


def unpack(s):
    """A record as (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        header = header._replace(label=np.frombuffer(
            s[:header.flag * 4], dtype=np.float32))
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """A header and an image array as one record, the image encoded by
    :func:`mxnet_tpu_torch.image.imencode` (JPEG at ``quality`` for
    '.jpg', PNG for '.png')."""
    from . import image as image_mod

    return pack(header, image_mod.imencode(img, img_fmt, quality))


def unpack_img(s, iscolor=-1):
    """A record as (IRHeader, HWC uint8 image)."""
    from . import image as image_mod

    header, img_bytes = unpack(s)
    return header, image_mod.imdecode(img_bytes, 1 if iscolor != 0 else 0,
                                      to_numpy=True)
