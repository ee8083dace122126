"""S3 Select execution: request parsing, CSV/JSON readers, output
serialization, and the AWS event-stream response framing
(reference pkg/s3select/{select.go,csv,json,message.go}).

A copy of minio_tpu/s3select/select.py. The scan plane
(scan/engine.py) reuses its readers, `_emit` and `frame_records`, so a
Select served from the card frames its stream with this code."""

from __future__ import annotations

import bz2
import csv as _csv
import datetime as _dt
import gzip
import io
import json
import struct
import xml.etree.ElementTree as ET
import zlib
from typing import Iterator, Optional

from .sql import (Aggregator, Query, SQLError, evaluate,
                  format_sql_timestamp, parse)

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _find(el, tag):
    r = el.find(tag)
    if r is None:
        r = el.find(_NS + tag)
    return r


def _text(el, tag, default=""):
    r = _find(el, tag)
    return (r.text or "") if r is not None and r.text is not None \
        else default


class SelectRequest:
    """Parsed SelectObjectContent XML body."""

    def __init__(self):
        self.expression = ""
        self.input_format = "CSV"          # CSV | JSON
        self.compression = "NONE"          # NONE | GZIP | BZIP2
        self.csv_header = "NONE"           # NONE | USE | IGNORE
        self.csv_delim = ","
        self.csv_quote = '"'
        self.json_type = "LINES"           # LINES | DOCUMENT
        self.output_format = "CSV"
        self.out_delim = ","
        self.out_quote = '"'
        self.out_record_delim = "\n"

    @classmethod
    def from_xml(cls, raw: bytes) -> "SelectRequest":
        from ..s3.s3errors import S3Error
        try:
            root = ET.fromstring(raw)
        except ET.ParseError as e:
            raise S3Error("MalformedXML", str(e)) from None
        r = cls()
        r.expression = _text(root, "Expression").strip()
        if _text(root, "ExpressionType", "SQL").upper() != "SQL":
            raise S3Error("InvalidArgument", "ExpressionType must be SQL")
        inp = _find(root, "InputSerialization")
        if inp is not None:
            r.compression = (_text(inp, "CompressionType", "NONE")
                             or "NONE").upper()
            csv_el = _find(inp, "CSV")
            json_el = _find(inp, "JSON")
            if json_el is not None:
                r.input_format = "JSON"
                r.json_type = (_text(json_el, "Type", "LINES")
                               or "LINES").upper()
            elif csv_el is not None:
                r.input_format = "CSV"
                r.csv_header = (_text(csv_el, "FileHeaderInfo", "NONE")
                                or "NONE").upper()
                r.csv_delim = _text(csv_el, "FieldDelimiter", ",") or ","
                r.csv_quote = _text(csv_el, "QuoteCharacter", '"') or '"'
            elif _find(inp, "Parquet") is not None:
                r.input_format = "PARQUET"
                r.compression = "NONE"   # parquet is self-compressed
        out = _find(root, "OutputSerialization")
        if out is not None:
            if _find(out, "JSON") is not None:
                r.output_format = "JSON"
                jr = _find(out, "JSON")
                r.out_record_delim = _text(jr, "RecordDelimiter",
                                           "\n") or "\n"
            elif _find(out, "CSV") is not None:
                r.output_format = "CSV"
                co = _find(out, "CSV")
                r.out_delim = _text(co, "FieldDelimiter", ",") or ","
                r.out_quote = _text(co, "QuoteCharacter", '"') or '"'
                r.out_record_delim = _text(co, "RecordDelimiter",
                                           "\n") or "\n"
        if not r.expression:
            raise S3Error("InvalidArgument", "missing Expression")
        return r


# -- input readers ----------------------------------------------------------

def _decompress(data: bytes, kind: str) -> bytes:
    if kind == "GZIP":
        return gzip.decompress(data)
    if kind == "BZIP2":
        return bz2.decompress(data)
    return data


def _rows_csv(data: bytes, req: SelectRequest) -> Iterator[dict]:
    text = data.decode("utf-8", errors="replace")
    reader = _csv.reader(io.StringIO(text), delimiter=req.csv_delim,
                         quotechar=req.csv_quote)
    header: Optional[list[str]] = None
    for i, rec in enumerate(reader):
        if not rec:
            continue
        if i == 0 and req.csv_header in ("USE", "IGNORE"):
            if req.csv_header == "USE":
                header = rec
            continue
        if header is not None:
            yield {header[j] if j < len(header) else f"_{j + 1}": v
                   for j, v in enumerate(rec)}
        else:
            yield {f"_{j + 1}": v for j, v in enumerate(rec)}


def _rows_parquet(data: bytes, req: SelectRequest) -> Iterator[dict]:
    """Columnar Parquet input (reference pkg/s3select/parquet): rows
    stream out batch-by-batch so a large file never materializes as one
    Python list. pyarrow does the columnar decode; values arrive as
    native Python types (int/float/str/bool/None), which the SQL
    evaluator handles like JSON values."""
    from ..s3.s3errors import S3Error
    try:
        import pyarrow.parquet as pq
    except ImportError:
        raise S3Error("NotImplemented",
                      "Parquet support needs pyarrow") from None
    try:
        pf = pq.ParquetFile(io.BytesIO(data))
    except Exception as e:  # noqa: BLE001 — arrow raises its own types
        raise S3Error("InvalidArgument",
                      f"bad Parquet object: {e}") from None
    batches = pf.iter_batches()
    while True:
        try:
            batch = next(batches)
        except StopIteration:
            return
        except Exception as e:  # noqa: BLE001 — a valid footer does
            # not guarantee valid data pages; decode errors surface
            # mid-iteration and must map to S3Error like CSV/JSON
            raise S3Error("InvalidArgument",
                          f"bad Parquet object: {e}") from None
        names = batch.schema.names
        cols = [c.to_pylist() for c in batch.columns]
        for i in range(batch.num_rows):
            yield {names[j]: cols[j][i] for j in range(len(names))}


def _rows_json(data: bytes, req: SelectRequest) -> Iterator[dict]:
    from ..s3.s3errors import S3Error
    text = data.decode("utf-8", errors="replace")
    if req.json_type == "DOCUMENT":
        try:
            doc = json.loads(text)
        except ValueError as e:
            raise S3Error("InvalidArgument", f"bad JSON: {e}") from None
        if isinstance(doc, list):
            for item in doc:
                yield item if isinstance(item, dict) else {"_1": item}
        else:
            yield doc if isinstance(doc, dict) else {"_1": doc}
        return
    dec = json.JSONDecoder()
    idx = 0
    n = len(text)
    while idx < n:
        while idx < n and text[idx] in " \t\r\n":
            idx += 1
        if idx >= n:
            break
        try:
            obj, end = dec.raw_decode(text, idx)
        except ValueError as e:
            raise S3Error("InvalidArgument", f"bad JSON: {e}") from None
        yield obj if isinstance(obj, dict) else {"_1": obj}
        idx = end


# -- output writers ---------------------------------------------------------

def _fmt_value(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, _dt.datetime):
        return format_sql_timestamp(v)
    return str(v)


def _json_default(v):
    if isinstance(v, _dt.datetime):
        return format_sql_timestamp(v)
    return str(v)


def _emit(row: dict, req: SelectRequest) -> bytes:
    if req.output_format == "JSON":
        return (json.dumps(row, default=_json_default)
                + req.out_record_delim).encode()
    buf = io.StringIO()
    w = _csv.writer(buf, delimiter=req.out_delim,
                    quotechar=req.out_quote,
                    lineterminator=req.out_record_delim)
    w.writerow([_fmt_value(v) for v in row.values()])
    return buf.getvalue().encode()


# -- engine -----------------------------------------------------------------

def run_select(req: SelectRequest, data: bytes) -> Iterator[bytes]:
    """Yields serialized output records for the query over `data`."""
    from ..s3.s3errors import S3Error
    try:
        q: Query = parse(req.expression)
    except SQLError as e:
        raise S3Error("InvalidArgument", f"SQL: {e}") from None
    data = _decompress(data, req.compression)
    if req.input_format == "JSON":
        rows = _rows_json(data, req)
    elif req.input_format == "PARQUET":
        rows = _rows_parquet(data, req)
    else:
        rows = _rows_csv(data, req)

    try:
        if q.is_aggregate:
            agg = Aggregator(q)
            for row in rows:
                if q.where is None or evaluate(q.where, row, q.alias):
                    agg.feed(row)
            yield _emit(agg.result(), req)
            return
        emitted = 0
        for row in rows:
            if q.where is not None and not evaluate(q.where, row,
                                                    q.alias):
                continue
            if q.star:
                out = dict(row)
            else:
                out = {}
                for i, (e, alias) in enumerate(q.projections):
                    from .sql import Col
                    name = alias or (e.name if isinstance(e, Col)
                                     else f"_{i + 1}")
                    out[name] = evaluate(e, row, q.alias)
            yield _emit(out, req)
            emitted += 1
            if q.limit is not None and emitted >= q.limit:
                return
    except SQLError as e:
        raise S3Error("InvalidArgument", f"SQL: {e}") from None


# -- AWS event-stream framing (pkg/s3select/message.go) ---------------------

def _header(name: str, value: str) -> bytes:
    nb = name.encode()
    vb = value.encode()
    return (bytes([len(nb)]) + nb + b"\x07"
            + struct.pack(">H", len(vb)) + vb)


def _message(headers: bytes, payload: bytes) -> bytes:
    total = 12 + len(headers) + len(payload) + 4
    prelude = struct.pack(">II", total, len(headers))
    pc = struct.pack(">I", zlib.crc32(prelude) & 0xffffffff)
    body = prelude + pc + headers + payload
    return body + struct.pack(">I", zlib.crc32(body) & 0xffffffff)


def records_message(payload: bytes) -> bytes:
    return _message(
        _header(":message-type", "event")
        + _header(":event-type", "Records")
        + _header(":content-type", "application/octet-stream"),
        payload)


def stats_message(scanned: int, processed: int, returned: int) -> bytes:
    xml = (f'<Stats xmlns="">'
           f"<BytesScanned>{scanned}</BytesScanned>"
           f"<BytesProcessed>{processed}</BytesProcessed>"
           f"<BytesReturned>{returned}</BytesReturned></Stats>")
    return _message(
        _header(":message-type", "event")
        + _header(":event-type", "Stats")
        + _header(":content-type", "text/xml"), xml.encode())


def end_message() -> bytes:
    return _message(
        _header(":message-type", "event")
        + _header(":event-type", "End"), b"")


def event_stream(req: SelectRequest, data: bytes) -> Iterator[bytes]:
    """Full SelectObjectContent response body."""
    yield from frame_records(run_select(req, data), len(data))


def frame_records(records: Iterator[bytes], data_len: int
                  ) -> Iterator[bytes]:
    """THE framing loop (128 KiB Records chunks, Stats over the raw
    object length, End) — shared with the device scan path
    (scan/engine.py), whose byte-identity guarantee would otherwise
    rest on a hand-synced copy."""
    returned = 0
    buf = b""
    for rec in records:
        buf += rec
        if len(buf) >= 128 * 1024:
            returned += len(buf)
            yield records_message(buf)
            buf = b""
    if buf:
        returned += len(buf)
        yield records_message(buf)
    yield stats_message(data_len, data_len, returned)
    yield end_message()
