"""
The Arrow IPC *file* format, read and written without pyarrow or the
flatbuffers package: the subset that pod5 files hold (a pod5 file embeds
three Arrow files; ``bonito_tpu_torch.pod5``).

A file is the magic ``ARROW1\\0\\0``, a stream of encapsulated messages
(0xFFFFFFFF, an int32 metadata length, a flatbuffer ``Message``, then the
message's body) and a footer: the flatbuffer ``Footer`` (the schema and the
blocks where each dictionary batch and record batch lies), its int32
length and ``ARROW1``. The flatbuffers (``Schema.fbs``, ``Message.fbs``,
``File.fbs`` of the Arrow format, version 5) are read by hand with
``struct`` and written by a small serialiser below, which pod5's own footer
uses too.

Read: integers, floats, bool, timestamp, date, time, duration,
fixed-size binary, binary and utf8 (and their large forms), list and large
list, dictionary-encoded columns (with delta batches), validity bitmaps,
any number of record batches; extension types read as their storage
type. Struct, map, decimal and other columns are laid out, so the columns
after them are found, but not decoded. A body
compressed with LZ4 or ZSTD (``RecordBatch.compression``) is refused: pod5
files do not use it. Columns are numpy views of the file's bytes; a value
of a variable-length column is a view of its row.

Written (``write_file``): the columns pod5 files need, without nulls.
"""

import struct
from bisect import bisect_right
from datetime import datetime, timedelta, timezone

import numpy as np

MAGIC = b"ARROW1"
_CONTINUATION = b"\xff\xff\xff\xff"
_V5 = 4  # MetadataVersion.V5

# the Type union of Schema.fbs
_TYPE_IDS = {1: "null", 2: "int", 3: "float", 4: "binary", 5: "utf8",
             6: "bool", 7: "decimal", 8: "date", 9: "time", 10: "timestamp",
             11: "interval", 12: "list", 13: "struct", 14: "union",
             15: "fixed_size_binary", 16: "fixed_size_list", 17: "map",
             18: "duration", 19: "large_binary", 20: "large_utf8",
             21: "large_list"}
_TYPE_NUMBERS = {v: k for k, v in _TYPE_IDS.items()}
# buffers an array of each type has in a record batch, before its children
_BUFFERS = {"null": 0, "int": 2, "float": 2, "bool": 2, "decimal": 2,
            "date": 2, "time": 2, "timestamp": 2, "interval": 2,
            "duration": 2, "fixed_size_binary": 2, "binary": 3, "utf8": 3,
            "large_binary": 3, "large_utf8": 3, "list": 2, "large_list": 2,
            "map": 2, "fixed_size_list": 1, "struct": 1}
_HEADER_SCHEMA, _HEADER_DICTIONARY, _HEADER_RECORD_BATCH = 1, 2, 3
_UNITS = {0: 1_000_000, 1: 1_000, 2: 1, 3: None}  # TimeUnit -> us per unit
_EPOCH = datetime(1970, 1, 1)


class ArrowError(ValueError):
    """The bytes are not an Arrow file this module reads."""


# ---------------------------------------------------------------------------
# flatbuffers, read
# ---------------------------------------------------------------------------

class FlatTable:
    """A flatbuffer table at ``pos`` of ``buf``: its fields by slot."""

    __slots__ = ("buf", "pos", "vtable", "vtable_len")

    def __init__(self, buf, pos):
        self.buf, self.pos = buf, pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vtable_len = struct.unpack_from("<H", buf, self.vtable)[0]

    @classmethod
    def root(cls, buf):
        return cls(buf, struct.unpack_from("<I", buf, 0)[0])

    def _field(self, slot):
        o = 4 + 2 * slot
        if o >= self.vtable_len:
            return 0
        off = struct.unpack_from("<H", self.buf, self.vtable + o)[0]
        return self.pos + off if off else 0

    def _deref(self, p):
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def scalar(self, slot, fmt, default=0):
        p = self._field(slot)
        return struct.unpack_from("<" + fmt, self.buf, p)[0] if p else default

    def table(self, slot):
        p = self._field(slot)
        return FlatTable(self.buf, self._deref(p)) if p else None

    def string(self, slot):
        p = self._field(slot)
        if not p:
            return None
        s = self._deref(p)
        n = struct.unpack_from("<I", self.buf, s)[0]
        return bytes(self.buf[s + 4:s + 4 + n]).decode()

    def _vector(self, slot):
        p = self._field(slot)
        if not p:
            return 0, 0
        s = self._deref(p)
        return s + 4, struct.unpack_from("<I", self.buf, s)[0]

    def tables(self, slot):
        start, n = self._vector(slot)
        return [FlatTable(self.buf, self._deref(start + 4 * i))
                for i in range(n)]

    def structs(self, slot, fmt):
        start, n = self._vector(slot)
        size = struct.calcsize(fmt)
        return list(struct.iter_unpack(fmt, self.buf[start:start + n * size]))


# ---------------------------------------------------------------------------
# flatbuffers, written
# ---------------------------------------------------------------------------

class Table:
    """A flatbuffer table to write: ``fields[slot]`` is None (absent), a
    (struct format, value) scalar, or an object it refers to: a Table, a
    str, a list of Tables, or a Structs vector."""

    def __init__(self, *fields):
        self.fields = fields


class Structs:
    """A vector of structs (or scalars) of one struct format."""

    def __init__(self, fmt, rows, align=8):
        self.fmt, self.rows, self.align = fmt, rows, align


def _pad_to(out, align, extra=0):
    """Zero bytes until len(out) + extra is a multiple of ``align``."""
    out += b"\0" * (-(len(out) + extra) % align)


def _emit(out, obj, todo):
    """Append ``obj`` to ``out``; queue what it refers to as (position of
    the reference, object). Its position."""
    if isinstance(obj, str):
        _pad_to(out, 4)
        pos = len(out)
        data = obj.encode()
        out += struct.pack("<I", len(data)) + data + b"\0"
        return pos
    if isinstance(obj, Structs):
        _pad_to(out, max(obj.align, 4), extra=4)
        pos = len(out)
        out += struct.pack("<I", len(obj.rows))
        for row in obj.rows:
            out += struct.pack("<" + obj.fmt, *row)
        return pos
    if isinstance(obj, list):
        _pad_to(out, 4)
        pos = len(out)
        out += struct.pack("<I", len(obj))
        for t in obj:
            todo.append((len(out), t))
            out += b"\0\0\0\0"
        return pos
    # a table: its vtable, then the table itself, each field at a position
    # aligned to its size, the widest first
    present = [(slot, f) for slot, f in enumerate(obj.fields) if f is not None]
    width = {slot: (struct.calcsize(f[0]) if isinstance(f, tuple) else 4)
             for slot, f in present}
    _pad_to(out, 2)
    vt_pos = len(out)
    vt_len = 4 + 2 * len(obj.fields)
    table_pos = vt_pos + vt_len + (-(vt_pos + vt_len) % 4)
    offsets, cur = {}, table_pos + 4
    for slot, _ in sorted(present, key=lambda sf: -width[sf[0]]):
        cur += -cur % width[slot]
        offsets[slot] = cur - table_pos
        cur += width[slot]
    out += struct.pack("<HH", vt_len, cur - table_pos)
    out += struct.pack(f"<{len(obj.fields)}H",
                       *(offsets.get(s, 0) for s in range(len(obj.fields))))
    out += b"\0" * (table_pos - len(out))
    out += struct.pack("<i", table_pos - vt_pos)
    body = bytearray(cur - table_pos - 4)
    for slot, f in present:
        at = offsets[slot] - 4
        if isinstance(f, tuple):
            struct.pack_into("<" + f[0], body, at, f[1])
        else:
            todo.append((table_pos + offsets[slot], f))
    out += body
    return table_pos


def serialize(root):
    """The bytes of a flatbuffer whose root is the Table ``root``; every
    object is written after what refers to it (uoffsets are unsigned)."""
    out = bytearray(8)
    todo = [(0, root)]
    i = 0
    while i < len(todo):
        at, obj = todo[i]
        i += 1
        pos = _emit(out, obj, todo)
        struct.pack_into("<I", out, at, pos - at)
    _pad_to(out, 8)
    return bytes(out)


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

class Field:
    """A field of a schema: name, type kind and parameters, children and
    dictionary encoding (id, index bit width, signed)."""

    def __init__(self, name, kind, params=None, children=(),
                 dictionary=None):
        self.name, self.kind = name, kind
        self.params = params or {}
        self.children = list(children)
        self.dictionary = dictionary

    def __repr__(self):
        return f"Field({self.name!r}, {self.kind!r}, {self.params})"


def _type_params(kind, t):
    if t is None:
        return {}
    if kind == "int":
        return {"bit_width": t.scalar(0, "i"), "signed": t.scalar(1, "?")}
    if kind == "float":
        return {"precision": t.scalar(0, "h")}
    if kind == "fixed_size_binary":
        return {"byte_width": t.scalar(0, "i")}
    if kind == "timestamp":
        return {"unit": t.scalar(0, "h"), "tz": t.string(1)}
    if kind == "date":
        return {"unit": t.scalar(0, "h", 1)}
    if kind == "time":
        return {"bit_width": t.scalar(1, "i", 32)}
    return {}


def _read_field(t):
    type_id = t.scalar(2, "B")
    kind = _TYPE_IDS.get(type_id)
    if kind is None or kind == "union":
        raise ArrowError(f"arrow: type {type_id} of field {t.string(0)!r} "
                         f"is not read")
    d = t.table(4)
    dictionary = None
    if d is not None:
        index = d.table(1)
        dictionary = {"id": d.scalar(0, "q"),
                      "bit_width": index.scalar(0, "i") if index else 32,
                      "signed": index.scalar(1, "?") if index else True}
    return Field(t.string(0) or "", kind, _type_params(kind, t.table(3)),
                 [_read_field(c) for c in t.tables(5)], dictionary)


def _read_schema(t):
    if t.scalar(0, "h") != 0:
        raise ArrowError("arrow: big-endian data is not read")
    return [_read_field(f) for f in t.tables(1)]


# ---------------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------------

def _int_dtype(bit_width, signed):
    return np.dtype(f"<{'i' if signed else 'u'}{bit_width // 8}")


def _fixed_dtype(field):
    """The numpy dtype of a fixed-width column's values, or None."""
    k, p = field.kind, field.params
    if k == "int":
        return _int_dtype(p["bit_width"], p["signed"])
    if k == "float":
        return np.dtype(["<f2", "<f4", "<f8"][p["precision"]])
    if k in ("timestamp", "duration"):
        return np.dtype("<i8")
    if k == "date":
        return np.dtype("<i4" if p["unit"] == 0 else "<i8")
    if k == "time":
        return np.dtype(f"<i{p['bit_width'] // 8}")
    return None


class _Array:
    """One array of a record batch: its length, null count, buffers (as
    memoryviews of the body) and children, as the batch lays them out."""

    __slots__ = ("field", "length", "nulls", "buffers", "children",
                 "_valid")

    def __init__(self, field, length, nulls, buffers, children):
        self.field, self.length, self.nulls = field, length, nulls
        self.buffers, self.children = buffers, children
        self._valid = False  # not unpacked yet

    def valid(self):
        """Validity as a bool array, or None where nothing is null."""
        if self._valid is False:
            self._valid = None
            if self.nulls and self.buffers and len(self.buffers[0]):
                bits = np.frombuffer(self.buffers[0], np.uint8)
                self._valid = np.unpackbits(
                    bits, bitorder="little")[:self.length].astype(bool)
        return self._valid


def _layout(field, nodes, buffers, body, dictionary_field=False):
    """The _Array of ``field`` from the batch's node and buffer iterators
    (flattened in pre-order), its buffers sliced out of ``body``."""
    try:
        length, nulls = next(nodes)
    except StopIteration:
        raise ArrowError("arrow: the batch has fewer nodes than its schema")
    if dictionary_field:  # the dictionary's values, not its indices
        field = Field(field.name, field.kind, field.params, field.children)
    kind = "int" if field.dictionary else field.kind
    bufs = []
    for _ in range(_BUFFERS[kind]):
        try:
            off, size = next(buffers)
        except StopIteration:
            raise ArrowError("arrow: the batch has fewer buffers than its "
                             "schema")
        if off < 0 or off + size > len(body):
            raise ArrowError("arrow: a buffer lies outside the body")
        bufs.append(body[off:off + size])
    children = []
    if not field.dictionary:
        children = [_layout(c, nodes, buffers, body) for c in field.children]
    return _Array(field, length, nulls, bufs, children)


def _record_batch(t, fields, body, dictionary_field=False):
    """The _Arrays of a RecordBatch flatbuffer over its body."""
    if t.table(3) is not None:
        raise ArrowError("arrow: compressed record batch bodies (LZ4/ZSTD) "
                         "are not read; pod5 files do not use them")
    nodes = iter(t.structs(1, "<qq"))
    buffers = iter(t.structs(2, "<qq"))
    arrays = [_layout(f, nodes, buffers, body, dictionary_field)
              for f in fields]
    if next(nodes, None) is not None or next(buffers, None) is not None:
        raise ArrowError("arrow: the batch has more nodes or buffers than "
                         "its schema")
    return t.scalar(0, "q"), arrays


def _offsets(array, dtype):
    return np.frombuffer(array.buffers[1], dtype, count=array.length + 1)


def _value(array, i, dictionaries):
    """Row ``i`` of an _Array as a Python value (None where null)."""
    valid = array.valid()
    if valid is not None and not valid[i]:
        return None
    f = array.field
    if f.dictionary is not None:
        index = np.frombuffer(array.buffers[1], _int_dtype(
            f.dictionary["bit_width"], f.dictionary["signed"]),
            count=array.length)[i]
        return dictionaries[f.dictionary["id"]][int(index)]
    return _plain_value(array, i, dictionaries)


def _plain_value(array, i, dictionaries):
    f, k = array.field, array.field.kind
    dtype = _fixed_dtype(f)
    if dtype is not None:
        v = np.frombuffer(array.buffers[1], dtype, count=array.length)[i]
        if k == "timestamp":
            us = _UNITS[f.params["unit"]]
            v = int(v)
            delta = (timedelta(microseconds=v * us) if us
                     else timedelta(microseconds=v // 1000))
            if f.params["tz"] is None:
                return _EPOCH + delta
            return _EPOCH.replace(tzinfo=timezone.utc) + delta
        return v.item()
    if k == "bool":
        bits = np.frombuffer(array.buffers[1], np.uint8)
        return bool(bits[i >> 3] >> (i & 7) & 1)
    if k == "null":
        return None
    if k == "fixed_size_binary":
        w = f.params["byte_width"]
        return bytes(array.buffers[1][i * w:(i + 1) * w])
    if k in ("binary", "utf8", "large_binary", "large_utf8"):
        o = _offsets(array, "<i8" if k.startswith("large") else "<i4")
        data = array.buffers[2][o[i]:o[i + 1]]
        return bytes(data).decode() if k.endswith("utf8") else data
    if k in ("list", "large_list"):
        o = _offsets(array, "<i8" if k == "large_list" else "<i4")
        return _values(array.children[0], dictionaries)[o[i]:o[i + 1]]
    raise ArrowError(f"arrow: values of type {k} are not read "
                     f"(field {f.name!r})")


def _values(array, dictionaries):
    """All values of a fixed-width _Array as one numpy array (nulls as
    whatever the buffer holds); other arrays as a list of values."""
    dtype = _fixed_dtype(array.field)
    if array.field.dictionary is None and dtype is not None:
        return np.frombuffer(array.buffers[1], dtype, count=array.length)
    if array.field.dictionary is None and array.field.kind == "bool":
        bits = np.frombuffer(array.buffers[1], np.uint8)
        return np.unpackbits(bits, bitorder="little")[
            :array.length].astype(bool)
    if (array.field.dictionary is None
            and array.field.kind == "fixed_size_binary"):
        w = array.field.params["byte_width"]
        return np.frombuffer(array.buffers[1], np.uint8,
                             count=array.length * w).reshape(-1, w)
    return [_value(array, i, dictionaries) for i in range(array.length)]


class Column:
    """One column over every record batch of a file."""

    def __init__(self, field, arrays, dictionaries):
        self.field = field
        self._arrays = arrays
        self._dictionaries = dictionaries
        self._starts = np.cumsum([0] + [a.length for a in arrays])

    def __len__(self):
        return int(self._starts[-1])

    def __getitem__(self, i):
        """Row ``i`` as a Python value: None where null; int, float,
        bool; bytes for fixed-size binary, a memoryview of the row for
        binary, str for utf8, a numpy view for a list; datetime for a
        timestamp (UTC-aware where the type names a time zone); the
        dictionary's value for a dictionary-encoded column."""
        if not 0 <= i < len(self):
            raise IndexError(f"row {i} of a column of {len(self)}")
        b = bisect_right(self._starts, i) - 1
        return _value(self._arrays[b], i - int(self._starts[b]),
                      self._dictionaries)

    def numpy(self):
        """The values of a fixed-width column as one numpy array
        ([rows, width] uint8 for fixed-size binary); nulls hold whatever
        their slots hold (``valid`` says which)."""
        parts = [_values(a, self._dictionaries) for a in self._arrays]
        if not all(isinstance(p, np.ndarray) for p in parts):
            raise ArrowError(f"arrow: column {self.field.name!r} "
                             f"({self.field.kind}) is not fixed-width")
        if not parts:
            return np.empty(0, _fixed_dtype(self.field) or np.uint8)
        return np.concatenate(parts)

    def valid(self):
        """Validity over all rows, or None where nothing is null."""
        masks = [a.valid() for a in self._arrays]
        if all(m is None for m in masks):
            return None
        return np.concatenate([np.ones(a.length, bool) if m is None else m
                               for a, m in zip(self._arrays, masks)])

    def to_list(self):
        return [self[i] for i in range(len(self))]


class ArrowFile:
    """An Arrow IPC file in a bytes-like buffer: its schema and columns.
    Record batches are laid out when the file is opened; values are
    decoded when a column is read."""

    def __init__(self, buf):
        buf = memoryview(buf)
        if (len(buf) < 18 or bytes(buf[:6]) != MAGIC
                or bytes(buf[-6:]) != MAGIC):
            raise ArrowError("arrow: no ARROW1 magic at both ends")
        (footer_len,) = struct.unpack_from("<i", buf, len(buf) - 10)
        start = len(buf) - 10 - footer_len
        if footer_len <= 0 or start < 8:
            raise ArrowError("arrow: bad footer length")
        try:
            footer = FlatTable.root(buf[start:start + footer_len])
            schema = footer.table(1)
            if schema is None:
                raise ArrowError("arrow: the footer has no schema")
            self.fields = _read_schema(schema)
            dict_blocks = footer.structs(2, "<qi4xq")
            batch_blocks = footer.structs(3, "<qi4xq")
            self._buf = buf
            by_id = {}
            _dictionary_fields(self.fields, by_id)
            self._dictionaries = {}
            for block in dict_blocks:
                self._read_dictionary(block, by_id)
            self._batches = [self._message(block, _HEADER_RECORD_BATCH)
                             for block in batch_blocks]
            self._batches = [_record_batch(t, self.fields, body)
                             for t, body in self._batches]
        except (struct.error, IndexError, KeyError, TypeError) as e:
            raise ArrowError(f"arrow: malformed file ({e})") from None
        self.num_rows = sum(n for n, _ in self._batches)
        self.names = [f.name for f in self.fields]
        self._columns = {}

    def _message(self, block, header):
        """(header FlatTable, body) of the message at ``block``."""
        offset, meta_len, body_len = block
        buf = self._buf
        pos = offset
        if bytes(buf[pos:pos + 4]) == _CONTINUATION:
            pos += 4
        (n,) = struct.unpack_from("<i", buf, pos)
        meta = buf[pos + 4:pos + 4 + n]
        message = FlatTable.root(meta)
        if message.scalar(1, "B") != header:
            raise ArrowError(f"arrow: message {message.scalar(1, 'B')} where "
                             f"{header} was expected")
        body_start = offset + meta_len
        if body_start + body_len > len(buf):
            raise ArrowError("arrow: a message body runs past the file")
        return message.table(2), buf[body_start:body_start + body_len]

    def _read_dictionary(self, block, by_id):
        t, body = self._message(block, _HEADER_DICTIONARY)
        did = t.scalar(0, "q")
        if did not in by_id:
            raise ArrowError(f"arrow: dictionary {did} names no field")
        _, (array,) = _record_batch(t.table(1), [by_id[did]], body,
                                    dictionary_field=True)
        values = _values(array, self._dictionaries)
        if isinstance(values, np.ndarray):  # as Python values
            values = ([bytes(v) for v in values] if values.ndim == 2
                      else values.tolist())
        if t.scalar(2, "?"):  # a delta: appended to the dictionary
            self._dictionaries.setdefault(did, []).extend(values)
        else:
            self._dictionaries[did] = values

    def column(self, name):
        if name not in self._columns:
            try:
                i = self.names.index(name)
            except ValueError:
                raise KeyError(f"arrow: no column {name!r}") from None
            self._columns[name] = Column(
                self.fields[i], [arrays[i] for _, arrays in self._batches],
                self._dictionaries)
        return self._columns[name]


def _dictionary_fields(fields, by_id):
    for f in fields:
        if f.dictionary is not None:
            by_id[f.dictionary["id"]] = f
        _dictionary_fields(f.children, by_id)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def int_type(bits, signed):
    return ("int", {"bit_width": bits, "signed": signed})


FLOAT32 = ("float", {"precision": 1})
UTF8 = ("utf8", {})
LARGE_BINARY = ("large_binary", {})


def fixed_size_binary(width):
    return ("fixed_size_binary", {"byte_width": width})


def large_list(item):
    return ("large_list", {"item": item})


def timestamp(unit="ms", tz=None):
    return ("timestamp", {"unit": ["s", "ms", "us", "ns"].index(unit),
                          "tz": tz})


def _type_table(kind, p):
    if kind == "int":
        return Table(("i", p["bit_width"]), ("?", p["signed"]))
    if kind == "float":
        return Table(("h", p["precision"]))
    if kind == "fixed_size_binary":
        return Table(("i", p["byte_width"]))
    if kind == "timestamp":
        return Table(("h", p["unit"]), p["tz"])
    return Table()


def _field_table(name, kind, p):
    children = [_field_table("item", *p["item"])] if kind == "large_list" \
        else []
    return Table(name, ("?", True), ("B", _TYPE_NUMBERS[kind]),
                 _type_table(kind, p), None, children)


def _schema_table(columns):
    return Table(("h", 0), [_field_table(name, kind, p)
                            for name, (kind, p), _ in columns])


def _column_buffers(kind, p, values):
    """The (nodes, buffers) of one column of ``values`` (no nulls)."""
    n = len(values)
    node = (n, 0)
    if kind in ("int", "float"):
        dtype = (_int_dtype(p["bit_width"], p["signed"]) if kind == "int"
                 else np.dtype(["<f2", "<f4", "<f8"][p["precision"]]))
        return [node], [b"", np.asarray(values, dtype).tobytes()]
    if kind == "timestamp":
        us = _UNITS[p["unit"]]

        def ticks(v):
            if v.tzinfo is not None:
                v = v.astimezone(timezone.utc).replace(tzinfo=None)
            return (v - _EPOCH) // timedelta(microseconds=us)
        return [node], [b"", np.asarray([ticks(v) for v in values],
                                        "<i8").tobytes()]
    if kind == "fixed_size_binary":
        data = b"".join(bytes(v) for v in values)
        if len(data) != n * p["byte_width"]:
            raise ValueError(f"fixed_size_binary({p['byte_width']}): a value "
                             f"of another width")
        return [node], [b"", data]
    if kind in ("utf8", "large_binary"):
        data = [v.encode() if isinstance(v, str) else bytes(v)
                for v in values]
        offsets = np.concatenate([[0], np.cumsum([len(d) for d in data],
                                                 dtype=np.int64)])
        dtype = "<i4" if kind == "utf8" else "<i8"
        return [node], [b"", offsets.astype(dtype).tobytes(), b"".join(data)]
    if kind == "large_list":
        item_kind, item_p = p["item"]
        parts = [np.asarray(v) for v in values]
        offsets = np.concatenate([[0], np.cumsum([len(v) for v in parts],
                                                 dtype=np.int64)])
        flat = np.concatenate(parts) if parts else np.empty(0)
        nodes, bufs = _column_buffers(item_kind, item_p, flat)
        return [node] + nodes, [b"", offsets.astype("<i8").tobytes()] + bufs
    raise ValueError(f"arrow: writing {kind} columns is not supported")


def _message(header_type, header, body_len):
    fb = serialize(Table(("h", _V5), ("B", header_type), header,
                         ("q", body_len)))
    return _CONTINUATION + struct.pack("<i", len(fb)) + fb


def write_file(columns):
    """The bytes of an Arrow IPC file of one record batch. ``columns`` is
    a list of (name, type, values), the type from ``int_type``,
    ``FLOAT32``, ``UTF8``, ``LARGE_BINARY``, ``fixed_size_binary``,
    ``large_list`` (of an int or float type) or ``timestamp``; no value is
    null."""
    lengths = {len(values) for _, _, values in columns}
    if len(lengths) > 1:
        raise ValueError("arrow: columns of different lengths")
    n_rows = lengths.pop() if lengths else 0
    nodes, buffers, body = [], [], bytearray()
    for _, (kind, p), values in columns:
        col_nodes, col_bufs = _column_buffers(kind, p, values)
        nodes += col_nodes
        for data in col_bufs:
            buffers.append((len(body), len(data)))
            body += data
            _pad_to(body, 8)
    schema = _schema_table(columns)
    out = bytearray(MAGIC + b"\0\0")
    out += _message(_HEADER_SCHEMA, schema, 0)
    batch = Table(("q", n_rows), Structs("qq", nodes), Structs("qq", buffers))
    block_offset = len(out)
    meta = _message(_HEADER_RECORD_BATCH, batch, len(body))
    out += meta + body
    out += _CONTINUATION + b"\0\0\0\0"  # end of stream
    footer = serialize(Table(("h", _V5), _schema_table(columns),
                             Structs("qi4xq", []),
                             Structs("qi4xq", [(block_offset, len(meta),
                                                len(body))])))
    out += footer + struct.pack("<i", len(footer)) + MAGIC
    return bytes(out)
