"""ctypes bridge to the native (C++) planner components.

Copied from `dask_sql_tpu/planner/native_bridge.py`; only where the library
comes from differs.  The port builds its own copy of the native planner
from `native/tokenizer.cpp`, `parser.cpp` and `binder.cpp` at first use
(`_build.native_library`), into its gitignored `_build/` directory, named by
a hash of the sources, and never writes into `native/`.  Each component
keeps a pure-Python fallback, so planning works when no C++ compiler is
present.
"""
from __future__ import annotations

import ctypes
import logging
import threading
from typing import List, Optional

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_TOKEN_TYPE_NAMES = ["IDENT", "QUOTED_IDENT", "NUMBER", "STRING", "OP", "PUNCT", "PARAM"]


def get_lib() -> Optional[ctypes.CDLL]:
    """The native planner library, built on first use; None when it cannot
    be built or loaded (the Python planner answers then)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from .._build import native_library

        try:
            path = native_library()
        except (OSError, RuntimeError) as e:
            logger.warning("native planner unavailable: %s", e)
            return None
        try:
            lib = ctypes.CDLL(str(path))
            lib.dsql_tokenize.restype = ctypes.c_int64
            lib.dsql_tokenize.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ]
            lib.dsql_tokenizer_abi_version.restype = ctypes.c_int32
            # once a process, at load: the ABI probe returns a constant
            # dsql: allow-blocking-under-lock — a one-time probe
            if lib.dsql_tokenizer_abi_version() != 1:
                return None
            _lib = lib
        except OSError:
            return None
        return _lib


def native_tokenize(sql: str):
    """Tokenize via the C++ lexer; returns a lexer.Token list or None."""
    from .lexer import Token, TokenType

    lib = get_lib()
    if lib is None:
        return None
    raw = sql.encode("utf-8")
    max_tokens = max(len(raw) // 2 + 16, 64)
    types = (ctypes.c_int32 * max_tokens)()
    starts = (ctypes.c_int64 * max_tokens)()
    lens = (ctypes.c_int64 * max_tokens)()
    count = lib.dsql_tokenize(raw, len(raw), types, starts, lens, max_tokens)
    if count < 0:
        from .lexer import LexError

        pos = -int(count) - 1
        raise LexError(f"Unexpected character at position {pos}")
    tokens: List[Token] = []
    for i in range(count):
        t = _TOKEN_TYPE_NAMES[types[i]]
        start, length = starts[i], lens[i]
        value = raw[start : start + length].decode("utf-8")
        if t == "STRING":
            value = value.replace("''", "'")
        elif t == "QUOTED_IDENT":
            value = value.replace('""', '"').replace("``", "`")
        tokens.append(Token(getattr(TokenType, t), value, start))
    end = len(raw)
    tokens.append(Token(TokenType.EOF, "", end))
    return tokens


# ---------------------------------------------------------------------------
# native parser (C++ parser.cpp) — flat node buffer -> sqlast objects
# ---------------------------------------------------------------------------
_parser_checked = False
_parser_ok = False

# kind constants (keep in sync with native/parser.cpp)
_K_STMT_LIST = 0; _K_QUERY_STMT = 1; _K_EXPLAIN_STMT = 2
_K_SELECT = 10; _K_PROJ_ITEM = 11; _K_FROM_CLAUSE = 12; _K_WHERE_CLAUSE = 13
_K_GROUP_ITEM = 14; _K_HAVING_CLAUSE = 15; _K_ORDER_ITEM = 16
_K_LIMIT_CLAUSE = 17; _K_OFFSET_CLAUSE = 18; _K_CTE = 19; _K_SETOP = 20
_K_DISTRIBUTE_ITEM = 21; _K_VALUES_ROW = 22; _K_NAMED_WINDOW = 23
_K_NAMED_TABLE = 30; _K_DERIVED_TABLE = 31; _K_TABLE_FUNC = 32; _K_JOIN = 33
_K_PART = 34; _K_ALIAS_COL = 35; _K_USING_COL = 36
_K_IDENT = 40; _K_WILDCARD = 41; _K_LIT_NULL = 42; _K_LIT_INT = 43
_K_LIT_FLOAT = 44; _K_LIT_STR = 45; _K_LIT_BOOL = 46; _K_LIT_TYPED = 47
_K_INTERVAL = 48; _K_UNARY = 49; _K_BINARY = 50; _K_CAST = 51; _K_CASE = 52
_K_FUNCALL = 53; _K_WINSPEC = 54; _K_FRAME = 55; _K_BETWEEN = 56
_K_INLIST = 57; _K_INSUBQ = 58; _K_EXISTS = 59; _K_SCALARSUBQ = 60
_K_LIKE = 61; _K_ISNULL = 62; _K_ISBOOL = 63; _K_ISDIST = 64; _K_EXTRACT = 65
_K_SUBSTRING = 66; _K_TRIM = 67; _K_POSITION = 68; _K_OVERLAY = 69
_K_CEILFLOORTO = 70; _K_GROUPING_SETS = 71; _K_SET_NODE = 72; _K_ROLLUP = 73
_K_CUBE = 74
_K_QNAME = 79; _K_CREATE_TABLE_WITH = 80; _K_CREATE_TABLE_AS = 81
_K_DROP_TABLE = 82; _K_CREATE_SCHEMA = 83; _K_DROP_SCHEMA = 84
_K_USE_SCHEMA = 85; _K_ALTER_SCHEMA = 86; _K_ALTER_TABLE = 87
_K_SHOW_SCHEMAS = 88; _K_SHOW_TABLES = 89; _K_SHOW_COLUMNS = 90
_K_SHOW_MODELS = 91; _K_ANALYZE_TABLE = 92; _K_CREATE_MODEL = 93
_K_DROP_MODEL = 94; _K_DESCRIBE_MODEL = 95; _K_EXPORT_MODEL = 96
_K_CREATE_EXPERIMENT = 97; _K_KWARGS = 98; _K_KV = 99; _K_KWLIST = 100
_K_SHOW_METRICS = 101; _K_SHOW_PROFILES = 102
_K_SHOW_QUERIES = 103; _K_CANCEL_QUERY = 104
_K_SHOW_MATERIALIZED = 105; _K_INSERT_INTO = 106
_K_SHOW_REPLICAS = 107

_FRAME_KINDS = ["UNBOUNDED_PRECEDING", "PRECEDING", "CURRENT_ROW",
                "FOLLOWING", "UNBOUNDED_FOLLOWING"]


def _get_parser_lib():
    global _parser_checked, _parser_ok
    lib = get_lib()
    if lib is None:
        return None
    if not _parser_checked:
        _parser_checked = True
        try:
            lib.dsql_parse.restype = ctypes.c_int32
            lib.dsql_parse.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.dsql_buf_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            lib.dsql_parser_abi_version.restype = ctypes.c_int32
            # grammar version 7 = SHOW REPLICAS (the fleet surface); a
            # stale .so predating it is rejected here so the Python parser
            # handles the syntax
            _parser_ok = lib.dsql_parser_abi_version() == 7
        except AttributeError:
            _parser_ok = False
    return lib if _parser_ok else None


class _FlatAst:
    __slots__ = ("nodes", "children", "strings", "root")

    MAGIC = 0x44535131

    def __init__(self, buf: bytes):
        import struct

        magic, n_nodes, n_children, n_strings, str_bytes, root, _ = \
            struct.unpack_from("<7i", buf, 0)
        if magic != self.MAGIC:
            raise ValueError("bad native buffer magic")
        self.nodes = []
        off = 28
        for _ in range(n_nodes):
            self.nodes.append(struct.unpack_from("<iiqdiiii", buf, off))
            off += 40
        self.children = struct.unpack_from(f"<{n_children}i", buf, off)
        off += 4 * n_children
        offs = struct.unpack_from(f"<{n_strings + 1}i", buf, off)
        off += 4 * (n_strings + 1)
        blob = buf[off : off + str_bytes]
        self.strings = [blob[offs[i]:offs[i + 1]].decode("utf-8")
                        for i in range(n_strings)]
        self.root = root

    def kids(self, nid):
        k = self.nodes[nid]
        return self.children[k[6] : k[6] + k[7]]

    def s(self, idx):
        return None if idx < 0 else self.strings[idx]


def _decode_expr(f: "_FlatAst", nid: int):
    from . import sqlast as a

    kind, flags, ival, dval, s0, s1, _, _ = f.nodes[nid]
    kids = f.kids(nid)
    if kind == _K_IDENT:
        parts, quoted = [], []
        for p in kids:
            pk = f.nodes[p]
            parts.append(f.s(pk[4]))
            quoted.append(bool(pk[1] & 1))
        return a.Identifier(parts, quoted)
    if kind == _K_WILDCARD:
        if flags & 1:
            return a.Wildcard([f.s(f.nodes[p][4]) for p in kids])
        return a.Wildcard()
    if kind == _K_LIT_NULL:
        return a.Literal(None)
    if kind == _K_LIT_INT:
        return a.Literal(ival)
    if kind == _K_LIT_FLOAT:
        return a.Literal(dval)
    if kind == _K_LIT_STR:
        return a.Literal(f.s(s0))
    if kind == _K_LIT_BOOL:
        return a.Literal(bool(ival))
    if kind == _K_LIT_TYPED:
        return a.Literal(f.s(s0), type_name=f.s(s1))
    if kind == _K_INTERVAL:
        return a.IntervalLiteral(f.s(s0), f.s(s1))
    if kind == _K_UNARY:
        return a.UnaryOp(f.s(s0), _decode_expr(f, kids[0]))
    if kind == _K_BINARY:
        return a.BinaryOp(f.s(s0), _decode_expr(f, kids[0]),
                          _decode_expr(f, kids[1]))
    if kind == _K_CAST:
        return a.Cast(_decode_expr(f, kids[0]), f.s(s0), safe=bool(flags & 1))
    if kind == _K_CASE:
        i = 0
        operand = None
        if flags & 1:
            operand = _decode_expr(f, kids[0])
            i = 1
        rest = kids[i:]
        n_when = (len(rest) - (1 if flags & 2 else 0)) // 2
        whens = [( _decode_expr(f, rest[2 * j]), _decode_expr(f, rest[2 * j + 1]))
                 for j in range(n_when)]
        else_ = _decode_expr(f, rest[-1]) if flags & 2 else None
        return a.Case(operand, whens, else_)
    if kind == _K_FUNCALL:
        args = [_decode_expr(f, k) for k in kids[:ival]]
        i = ival
        filt = None
        if flags & 4:
            filt = _decode_expr(f, kids[i])
            i += 1
        over = None
        if flags & 8:
            over = _decode_winspec(f, kids[i])
            i += 1
        elif flags & 16:
            over = f.s(s1)
        return a.FunctionCall(f.s(s0), args, bool(flags & 1), filt, over,
                              bool(flags & 2))
    if kind == _K_BETWEEN:
        return a.Between(_decode_expr(f, kids[0]), _decode_expr(f, kids[1]),
                         _decode_expr(f, kids[2]), bool(flags & 1),
                         bool(flags & 2))
    if kind == _K_INLIST:
        return a.InList(_decode_expr(f, kids[0]),
                        [_decode_expr(f, k) for k in kids[1:]],
                        bool(flags & 1))
    if kind == _K_INSUBQ:
        return a.InSubquery(_decode_expr(f, kids[0]),
                            _decode_select(f, kids[1]), bool(flags & 1))
    if kind == _K_EXISTS:
        return a.Exists(_decode_select(f, kids[0]), bool(flags & 1))
    if kind == _K_SCALARSUBQ:
        return a.ScalarSubquery(_decode_select(f, kids[0]))
    if kind == _K_LIKE:
        return a.Like(_decode_expr(f, kids[0]), _decode_expr(f, kids[1]),
                      bool(flags & 1), bool(flags & 2), bool(flags & 4),
                      f.s(s0) if flags & 8 else None)
    if kind == _K_ISNULL:
        return a.IsNull(_decode_expr(f, kids[0]), bool(flags & 1))
    if kind == _K_ISBOOL:
        return a.IsBool(_decode_expr(f, kids[0]), bool(flags & 2),
                        bool(flags & 1))
    if kind == _K_ISDIST:
        return a.IsDistinctFrom(_decode_expr(f, kids[0]),
                                _decode_expr(f, kids[1]), bool(flags & 1))
    if kind == _K_EXTRACT:
        return a.Extract(f.s(s0), _decode_expr(f, kids[0]))
    if kind == _K_SUBSTRING:
        start = _decode_expr(f, kids[1]) if flags & 1 else None
        length = _decode_expr(f, kids[2]) if flags & 2 else None
        return a.Substring(_decode_expr(f, kids[0]), start, length)
    if kind == _K_TRIM:
        chars = _decode_expr(f, kids[1]) if flags & 1 else None
        return a.Trim(_decode_expr(f, kids[0]), f.s(s0), chars)
    if kind == _K_POSITION:
        return a.Position(_decode_expr(f, kids[0]), _decode_expr(f, kids[1]))
    if kind == _K_OVERLAY:
        length = _decode_expr(f, kids[3]) if flags & 1 else None
        return a.Overlay(_decode_expr(f, kids[0]), _decode_expr(f, kids[1]),
                         _decode_expr(f, kids[2]), length)
    if kind == _K_CEILFLOORTO:
        return a.CeilFloorTo(f.s(s0), _decode_expr(f, kids[0]), f.s(s1))
    if kind == _K_GROUPING_SETS:
        return a.GroupingSets([[_decode_expr(f, e) for e in f.kids(sn)]
                               for sn in kids])
    if kind == _K_ROLLUP:
        return a.Rollup([_decode_expr(f, k) for k in kids])
    if kind == _K_CUBE:
        return a.Cube([_decode_expr(f, k) for k in kids])
    raise ValueError(f"unexpected native expr kind {kind}")


def _decode_order_item(f, nid):
    from . import sqlast as a

    _, flags, _, _, _, _, _, _ = f.nodes[nid]
    nulls_first = bool(flags & 4) if flags & 2 else None
    return a.OrderItem(_decode_expr(f, f.kids(nid)[0]), bool(flags & 1),
                       nulls_first)


def _decode_winspec(f, nid):
    from . import sqlast as a

    _, flags, npart, _, _, _, _, _ = f.nodes[nid]
    kids = list(f.kids(nid))
    has_frame = bool(flags & 1)
    frame_id = kids.pop() if has_frame else None
    spec = a.WindowSpec()
    spec.partition_by = [_decode_expr(f, k) for k in kids[:npart]]
    spec.order_by = [_decode_order_item(f, k) for k in kids[npart:]]
    if frame_id is not None:
        fk, fflags, fival, _, fs0, _, _, _ = f.nodes[frame_id]
        fkids = list(f.kids(frame_id))
        i = 0
        start_off = None
        if fflags & 1:
            start_off = _decode_expr(f, fkids[i]); i += 1
        end_off = None
        if fflags & 2:
            end_off = _decode_expr(f, fkids[i]); i += 1
        start = (_FRAME_KINDS[fival & 0xFF], start_off)
        end = (_FRAME_KINDS[(fival >> 8) & 0xFF], end_off)
        spec.frame = a.WindowFrame(f.s(fs0), start, end)
    return spec


def _decode_table_ref(f, nid):
    from . import sqlast as a

    kind, flags, ival, dval, s0, s1, _, _ = f.nodes[nid]
    kids = f.kids(nid)
    if kind == _K_NAMED_TABLE:
        parts = [f.s(f.nodes[k][4]) for k in kids
                 if f.nodes[k][0] == _K_PART]
        alias_cols = [f.s(f.nodes[k][4]) for k in kids
                      if f.nodes[k][0] == _K_ALIAS_COL]
        alias = f.s(s0)
        if alias_cols:
            alias = (alias, alias_cols)
        sample = None
        if flags & 1:
            sample = (f.s(s1), dval, None if ival < 0 else ival)
        return a.NamedTable(parts, alias, sample)
    if kind == _K_DERIVED_TABLE:
        alias_cols = [f.s(f.nodes[k][4]) for k in kids[1:]
                      if f.nodes[k][0] == _K_ALIAS_COL]
        alias = f.s(s0)
        if alias_cols:
            alias = (alias, alias_cols)
        return a.DerivedTable(_decode_select(f, kids[0]), alias)
    if kind == _K_TABLE_FUNC:
        parts = [f.s(f.nodes[k][4]) for k in kids
                 if f.nodes[k][0] == _K_PART]
        sel = next(k for k in kids if f.nodes[k][0] == _K_SELECT)
        return a.TableFunction(f.s(s0), parts, _decode_select(f, sel),
                               f.s(s1))
    if kind == _K_JOIN:
        left = _decode_table_ref(f, kids[0])
        right = _decode_table_ref(f, kids[1])
        jt = f.s(s0)
        condition = None
        using = None
        rest = kids[2:]
        if flags & 1:
            condition = _decode_expr(f, rest[0])
        elif flags & 2:
            using = [f.s(f.nodes[k][4]) for k in rest
                     if f.nodes[k][0] == _K_USING_COL]
        return a.Join(left, right, jt, condition, using)
    raise ValueError(f"unexpected native table-ref kind {kind}")


def _decode_select(f, nid):
    from . import sqlast as a

    kind, flags, _, _, _, _, _, _ = f.nodes[nid]
    if kind != _K_SELECT:
        raise ValueError(f"expected SELECT node, got {kind}")
    sel = a.Select()
    sel.distinct = bool(flags & 1)
    values_rows = []
    for k in f.kids(nid):
        ck, cflags, cival, cdval, cs0, cs1, _, _ = f.nodes[k]
        kk = f.kids(k)
        if ck == _K_PROJ_ITEM:
            sel.projections.append(
                a.SelectItem(_decode_expr(f, kk[0]), f.s(cs0)))
        elif ck == _K_FROM_CLAUSE:
            sel.from_ = _decode_table_ref(f, kk[0])
        elif ck == _K_WHERE_CLAUSE:
            sel.where = _decode_expr(f, kk[0])
        elif ck == _K_GROUP_ITEM:
            sel.group_by.append(_decode_expr(f, kk[0]))
        elif ck == _K_HAVING_CLAUSE:
            sel.having = _decode_expr(f, kk[0])
        elif ck == _K_ORDER_ITEM:
            sel.order_by.append(_decode_order_item(f, k))
        elif ck == _K_LIMIT_CLAUSE:
            sel.limit = cival
        elif ck == _K_OFFSET_CLAUSE:
            sel.offset = cival
        elif ck == _K_CTE:
            sel.ctes.append((f.s(cs0), _decode_select(f, kk[0])))
        elif ck == _K_SETOP:
            sel.set_op = (f.s(cs0), bool(cflags & 1),
                          _decode_select(f, kk[0]))
        elif ck == _K_DISTRIBUTE_ITEM:
            sel.distribute_by.append(_decode_expr(f, kk[0]))
        elif ck == _K_VALUES_ROW:
            values_rows.append([_decode_expr(f, e) for e in kk])
        elif ck == _K_NAMED_WINDOW:
            sel.named_windows[f.s(cs0)] = _decode_winspec(f, kk[0])
        else:
            raise ValueError(f"unexpected SELECT child kind {ck}")
    if values_rows:
        sel.values = values_rows
    return sel


def native_parse(sql: str):
    """Parse via the C++ parser; returns a list of sqlast.Statement or None
    when the native path is unavailable / the statement is unsupported.
    Raises ParsingException for genuine syntax errors (same format as the
    Python parser)."""
    lib = _get_parser_lib()
    if lib is None:
        return None
    raw = sql.encode("utf-8")
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    rc = lib.dsql_parse(raw, len(raw), ctypes.byref(out),
                        ctypes.byref(out_len))
    if rc == 1:
        return None
    try:
        buf = ctypes.string_at(out, out_len.value) if out_len.value else b""
    finally:
        if out:
            lib.dsql_buf_free(out)
    if rc == 2:
        import struct

        from .parser import ParsingException

        pos = struct.unpack_from("<q", buf, 0)[0]
        msg = buf[8:].decode("utf-8", "replace")
        ctx = sql[max(0, pos - 30) : pos + 30]
        raise ParsingException(f"{msg} at position {pos} (near {ctx!r})")
    try:
        f = _FlatAst(buf)
    except Exception:  # dsql: allow-broad-except — corrupt buffer -> Python fallback
        logger.debug("native AST decode failed", exc_info=True)
        return None
    from . import sqlast as a

    stmts = []
    for sid in f.kids(f.root):
        stmt = _decode_statement(f, sid)
        if stmt is None:
            return None
        stmts.append(stmt)
    return stmts


def _decode_qname(f: "_FlatAst", nid: int):
    return [f.s(f.nodes[p][4]) for p in f.kids(nid)]


def _decode_kwarg_value(f: "_FlatAst", nid: int):
    kind, flags, ival, dval, s0, s1, _, _ = f.nodes[nid]
    if kind == _K_LIT_STR:
        return f.s(s0)
    if kind == _K_LIT_INT:
        return ival
    if kind == _K_LIT_FLOAT:
        return dval
    if kind == _K_LIT_BOOL:
        return bool(ival)
    if kind == _K_LIT_NULL:
        return None
    if kind == _K_KWLIST:
        return [_decode_kwarg_value(f, k) for k in f.kids(nid)]
    if kind == _K_KWARGS:
        return _decode_kwargs(f, nid)
    raise ValueError(f"bad kwarg value kind {kind}")


def _decode_kwargs(f: "_FlatAst", nid: int):
    out = {}
    for kv in f.kids(nid):
        _, _, _, _, s0, _, _, _ = f.nodes[kv]
        out[f.s(s0)] = _decode_kwarg_value(f, f.kids(kv)[0])
    return out


def _decode_statement(f: "_FlatAst", sid: int):
    """One statement node -> sqlast.Statement, or None for unknown kinds
    (the caller then falls back to the Python parser wholesale)."""
    from . import sqlast as a

    kind, flags, _, _, s0, s1, _, _ = f.nodes[sid]
    kids = f.kids(sid)
    ine = bool(flags & 1)
    orr = bool(flags & 2)
    if kind == _K_QUERY_STMT:
        return a.QueryStatement(_decode_select(f, kids[0]))
    if kind == _K_EXPLAIN_STMT:
        return a.ExplainStatement(_decode_select(f, kids[0]), bool(flags & 1),
                                  bool(flags & 2), bool(flags & 4),
                                  bool(flags & 8))
    if kind == _K_CREATE_TABLE_WITH:
        return a.CreateTableWith(_decode_qname(f, kids[0]),
                                 _decode_kwargs(f, kids[1]), ine, orr)
    if kind == _K_CREATE_TABLE_AS:
        return a.CreateTableAs(_decode_qname(f, kids[0]),
                               _decode_select(f, kids[1]),
                               persist=bool(flags & 4),
                               if_not_exists=ine, or_replace=orr)
    if kind == _K_DROP_TABLE:
        return a.DropTable(_decode_qname(f, kids[0]), bool(flags & 1))
    if kind == _K_CREATE_SCHEMA:
        return a.CreateSchema(f.s(s0), ine, orr)
    if kind == _K_DROP_SCHEMA:
        return a.DropSchema(f.s(s0), bool(flags & 1))
    if kind == _K_USE_SCHEMA:
        return a.UseSchema(f.s(s0))
    if kind == _K_ALTER_SCHEMA:
        return a.AlterSchema(f.s(s0), f.s(s1))
    if kind == _K_ALTER_TABLE:
        return a.AlterTable(_decode_qname(f, kids[0]), f.s(s0),
                            bool(flags & 1))
    if kind == _K_SHOW_SCHEMAS:
        return a.ShowSchemas(f.s(s0))
    if kind == _K_SHOW_TABLES:
        return a.ShowTables(f.s(s0))
    if kind == _K_SHOW_COLUMNS:
        return a.ShowColumns(_decode_qname(f, kids[0]))
    if kind == _K_SHOW_MODELS:
        return a.ShowModels(f.s(s0))
    if kind == _K_SHOW_METRICS:
        return a.ShowMetrics(f.s(s0))
    if kind == _K_SHOW_PROFILES:
        return a.ShowProfiles(f.s(s0))
    if kind == _K_SHOW_QUERIES:
        return a.ShowQueries(f.s(s0))
    if kind == _K_CANCEL_QUERY:
        return a.CancelQuery(f.s(s0) or "")
    if kind == _K_SHOW_MATERIALIZED:
        return a.ShowMaterialized(f.s(s0))
    if kind == _K_SHOW_REPLICAS:
        return a.ShowReplicas(f.s(s0))
    if kind == _K_INSERT_INTO:
        return a.InsertInto(_decode_qname(f, kids[0]),
                            _decode_select(f, kids[1]))
    if kind == _K_ANALYZE_TABLE:
        cols = [f.s(f.nodes[p][4]) for p in kids[1:]]
        return a.AnalyzeTable(_decode_qname(f, kids[0]), cols)
    if kind == _K_CREATE_MODEL:
        return a.CreateModel(_decode_qname(f, kids[0]),
                             _decode_kwargs(f, kids[1]),
                             _decode_select(f, kids[2]), ine, orr)
    if kind == _K_DROP_MODEL:
        return a.DropModel(_decode_qname(f, kids[0]), bool(flags & 1))
    if kind == _K_DESCRIBE_MODEL:
        return a.DescribeModel(_decode_qname(f, kids[0]))
    if kind == _K_EXPORT_MODEL:
        return a.ExportModel(_decode_qname(f, kids[0]),
                             _decode_kwargs(f, kids[1]))
    if kind == _K_CREATE_EXPERIMENT:
        return a.CreateExperiment(_decode_qname(f, kids[0]),
                                  _decode_kwargs(f, kids[1]),
                                  _decode_select(f, kids[2]), ine, orr)
    return None


# ---------------------------------------------------------------------------
# native binder (C++ binder.cpp) — catalog encode + flat plan buffer decode
# ---------------------------------------------------------------------------
_binder_checked = False
_binder_ok = False

# plan-buffer kinds (keep in sync with native/binder.cpp)
_P_TABLESCAN = 1; _P_PROJECTION = 2; _P_FILTER = 3; _P_JOIN = 4
_P_CROSSJOIN = 5; _P_AGGREGATE = 6; _P_WINDOW = 7; _P_SORT = 8; _P_LIMIT = 9
_P_UNION = 10; _P_INTERSECT = 11; _P_EXCEPT = 12; _P_DISTINCT = 13
_P_VALUES = 14; _P_EMPTY = 15; _P_SUBQUERY_ALIAS = 16; _P_SAMPLE = 17
_P_DISTRIBUTE_BY = 18; _P_EXPLAIN = 19
_P_CREATE_TABLE = 20; _P_CREATE_MEMORY_TABLE = 21; _P_DROP_TABLE = 22
_P_CREATE_SCHEMA = 23; _P_DROP_SCHEMA = 24; _P_USE_SCHEMA = 25
_P_ALTER_SCHEMA = 26; _P_ALTER_TABLE = 27; _P_SHOW_SCHEMAS = 28
_P_SHOW_TABLES = 29; _P_SHOW_COLUMNS = 30; _P_SHOW_MODELS = 31
_P_ANALYZE_TABLE = 32; _P_CREATE_MODEL = 33; _P_DROP_MODEL = 34
_P_DESCRIBE_MODEL = 35; _P_EXPORT_MODEL = 36; _P_CREATE_EXPERIMENT = 37
_P_PREDICT_MODEL = 38; _P_SHOW_METRICS = 39; _P_SHOW_PROFILES = 40
_P_SHOW_QUERIES = 41; _P_CANCEL_QUERY = 42
_P_FIELD = 50; _P_SORTKEY = 51; _P_ON_PAIR = 52; _P_VALUES_ROW = 53
_P_PART = 54; _P_KWARGS = 55; _P_KV = 56; _P_KWLIST = 57; _P_WINSPEC = 58
_P_FRAME_BOUND = 59
_P_KW_STR = 60; _P_KW_INT = 61; _P_KW_FLOAT = 62; _P_KW_BOOL = 63
_P_KW_NULL = 64
_E_COLREF = 70; _E_LITERAL = 71; _E_SCALARFN = 72; _E_AGG = 73
_E_WINDOW = 74; _E_CAST = 75; _E_CASE = 76; _E_INLIST = 77; _E_INSUBQ = 78
_E_EXISTS = 79; _E_SCALARSUBQ = 80; _E_UDF = 81; _E_OUTERREF = 82
_E_GROUPING = 83

_LT_NULL = 0; _LT_BOOL = 1; _LT_INT = 2; _LT_FLOAT = 3; _LT_STR = 4

_PLAN_FRAME_KINDS = ["UNBOUNDED_PRECEDING", "PRECEDING", "CURRENT_ROW",
                     "FOLLOWING", "UNBOUNDED_FOLLOWING"]


def _sql_type_ids():
    from ..columnar.dtypes import SqlType

    return list(SqlType)  # declaration order == C++ Ty enum order


def _get_binder_lib():
    global _binder_checked, _binder_ok
    lib = get_lib()
    if lib is None:
        return None
    if not _binder_checked:
        _binder_checked = True
        try:
            lib.dsql_bind.restype = ctypes.c_int32
            lib.dsql_bind.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.dsql_binder_abi_version.restype = ctypes.c_int32
            # version 6 = P_SHOW_QUERIES + P_CANCEL_QUERY
            _binder_ok = lib.dsql_binder_abi_version() == 6
        except AttributeError:
            _binder_ok = False
    return lib if _binder_ok else None


def encode_catalog(catalog) -> bytes:
    """Serialize the planner catalog for dsql_bind (schemas/tables/columns +
    UDF signatures; see native/binder.cpp Catalog::load for the layout)."""
    import struct

    type_ids = {t: i for i, t in enumerate(_sql_type_ids())}
    out = bytearray()

    def w32(v):
        out.extend(struct.pack("<i", v))

    def wstr(s):
        raw = s.encode("utf-8")
        w32(len(raw))
        out.extend(raw)

    w32(0x44535143)
    w32(1 if catalog.case_sensitive else 0)
    wstr(catalog.current_schema)
    w32(len(catalog.schemas))
    for sname, schema in catalog.schemas.items():
        wstr(sname)
        w32(len(schema.tables))
        for tname, table in schema.tables.items():
            wstr(tname)
            rc = table.statistics.row_count if table.statistics else None
            out.extend(struct.pack("<d", -1.0 if rc is None else float(rc)))
            w32(len(table.fields))
            for f in table.fields:
                wstr(f.name)
                w32(type_ids[f.sql_type])
                w32(1 if f.nullable else 0)
        w32(len(schema.functions))
        for fname, fds in schema.functions.items():
            wstr(fname)
            w32(len(fds))
            for fd in fds:
                wstr(fd.name)
                w32(len(fd.parameters))
                for _, pt in fd.parameters:
                    w32(type_ids[pt])
                w32(type_ids[fd.return_type])
                w32(1 if fd.aggregation else 0)
                w32(1 if fd.row_udf else 0)
    return bytes(out)


class _FlatPlan(_FlatAst):
    """Same framing as the AST buffer, 'DSQB' magic."""

    MAGIC = 0x44535142


class _PlanDecoder:
    def __init__(self, f: _FlatPlan):
        self.f = f
        self.types = _sql_type_ids()
        self.plan_memo = {}  # node id -> plan object (preserves CTE sharing)

    # -------- aux --------
    def field(self, nid):
        from .expressions import Field

        _, flags, _, _, s0, _, _, _ = self.f.nodes[nid]
        return Field(self.f.s(s0), self.types[flags >> 8], bool(flags & 1))

    def fields(self, ids):
        return [self.field(i) for i in ids]

    def sortkey(self, nid):
        from .expressions import SortKey

        _, flags, _, _, _, _, _, _ = self.f.nodes[nid]
        nulls_first = bool(flags & 4) if flags & 2 else None
        return SortKey(self.expr(self.f.kids(nid)[0]), bool(flags & 1),
                       nulls_first)

    def winspec(self, nid):
        from .expressions import WindowFrameBound, WindowSpec

        _, flags, npart, _, s0, _, _, _ = self.f.nodes[nid]
        kids = list(self.f.kids(nid))
        end_b = kids.pop()
        start_b = kids.pop()
        partition = tuple(self.expr(k) for k in kids[:npart])
        order = tuple(self.sortkey(k) for k in kids[npart:])

        def bound(bid):
            _, bflags, bival, bdval, _, _, _, _ = self.f.nodes[bid]
            kind = _PLAN_FRAME_KINDS[bflags >> 4]
            off = None
            if bflags & 1:
                off = bdval if bflags & 2 else bival
            return WindowFrameBound(kind, off)

        return WindowSpec(partition, order, self.f.s(s0), bound(start_b),
                          bound(end_b), bool(flags & 1))

    def kwvalue(self, nid):
        kind, _, ival, dval, s0, _, _, _ = self.f.nodes[nid]
        if kind == _P_KW_STR:
            return self.f.s(s0)
        if kind == _P_KW_INT:
            return ival
        if kind == _P_KW_FLOAT:
            return dval
        if kind == _P_KW_BOOL:
            return bool(ival)
        if kind == _P_KW_NULL:
            return None
        if kind == _P_KWLIST:
            return [self.kwvalue(k) for k in self.f.kids(nid)]
        if kind == _P_KWARGS:
            return self.kwargs(nid)
        raise ValueError(f"bad kw kind {kind}")

    def kwargs(self, nid):
        out = {}
        for kv in self.f.kids(nid):
            _, _, _, _, s0, _, _, _ = self.f.nodes[kv]
            out[self.f.s(s0)] = self.kwvalue(self.f.kids(kv)[0])
        return out

    def parts(self, ids):
        return [self.f.s(self.f.nodes[i][4]) for i in ids]

    # -------- expressions --------
    def expr(self, nid):
        from ..columnar.dtypes import SqlType
        from .binder import _OuterRef
        from .expressions import (
            AggExpr, CaseExpr, Cast, ColumnRef, ExistsExpr, GroupingExpr,
            InListExpr, InSubqueryExpr, Literal, ScalarFunc,
            ScalarSubqueryExpr, UdfExpr, WindowExpr,
        )

        kind, flags, ival, dval, s0, s1, _, _ = self.f.nodes[nid]
        ty = self.types[flags >> 8]
        kids = self.f.kids(nid)
        if kind == _E_COLREF:
            return ColumnRef(ival, self.f.s(s0), ty, bool(flags & 1))
        if kind == _E_OUTERREF:
            return _OuterRef(ival, self.f.s(s0), ty, bool(flags & 1))
        if kind == _E_LITERAL:
            tag = flags & 0xFF
            if tag == _LT_NULL:
                v = None
            elif tag == _LT_BOOL:
                v = bool(ival)
            elif tag == _LT_INT:
                v = ival
            elif tag == _LT_FLOAT:
                v = dval
            else:
                v = self.f.s(s0)
            return Literal(v, ty)
        if kind == _E_SCALARFN:
            return ScalarFunc(self.f.s(s0),
                              tuple(self.expr(k) for k in kids), ty)
        if kind == _E_AGG:
            has_filter = bool(flags & 2)
            args = kids[:-1] if has_filter else kids
            filt = self.expr(kids[-1]) if has_filter else None
            return AggExpr(self.f.s(s0), tuple(self.expr(k) for k in args),
                           ty, bool(flags & 1), filt)
        if kind == _E_WINDOW:
            spec = self.winspec(kids[-1])
            return WindowExpr(self.f.s(s0),
                              tuple(self.expr(k) for k in kids[:-1]), spec,
                              ty, bool(flags & 1))
        if kind == _E_CAST:
            return Cast(self.expr(kids[0]), ty, bool(flags & 1))
        if kind == _E_CASE:
            has_else = bool(flags & 1)
            body = kids[:-1] if has_else else kids
            whens = tuple((self.expr(body[2 * i]), self.expr(body[2 * i + 1]))
                          for i in range(len(body) // 2))
            else_ = self.expr(kids[-1]) if has_else else None
            return CaseExpr(whens, else_, ty)
        if kind == _E_INLIST:
            return InListExpr(self.expr(kids[0]),
                              tuple(self.expr(k) for k in kids[1:]),
                              bool(flags & 1))
        if kind == _E_INSUBQ:
            return InSubqueryExpr(self.expr(kids[0]), self.plan(kids[1]),
                                  bool(flags & 1))
        if kind == _E_EXISTS:
            return ExistsExpr(self.plan(kids[0]), bool(flags & 1))
        if kind == _E_SCALARSUBQ:
            return ScalarSubqueryExpr(self.plan(kids[0]), ty)
        if kind == _E_UDF:
            return UdfExpr(self.f.s(s0), tuple(self.expr(k) for k in kids),
                           ty, bool(flags & 1))
        if kind == _E_GROUPING:
            return GroupingExpr(tuple(self.expr(k) for k in kids),
                                SqlType.INTEGER)
        raise ValueError(f"bad expr kind {kind}")

    # -------- plans --------
    def plan(self, nid):
        if nid in self.plan_memo:
            return self.plan_memo[nid]
        out = self._plan(nid)
        self.plan_memo[nid] = out
        return out

    def _split(self, ids, kind):
        """(of_kind, rest) preserving order."""
        of_kind = [i for i in ids if self.f.nodes[i][0] == kind]
        rest = [i for i in ids if self.f.nodes[i][0] != kind]
        return of_kind, rest

    def _plan(self, nid):
        from . import plan as p

        kind, flags, ival, dval, s0, s1, _, _ = self.f.nodes[nid]
        kids = list(self.f.kids(nid))
        F = self.f
        if kind == _P_TABLESCAN:
            # optimizer-extended scans: ival = nf when flags bit0 (projection
            # pushed) or bit1 (filters pushed); P_PART kids = projection
            # column names; remaining kids = pushed filter exprs
            if flags & 3:
                nf = ival
                fields = self.fields(kids[:nf])
                rest = kids[nf:]
                parts = [k for k in rest if F.nodes[k][0] == _P_PART]
                fexprs = [k for k in rest if F.nodes[k][0] != _P_PART]
                projection = self.parts(parts) if flags & 1 else None
                return p.TableScan(F.s(s0), F.s(s1), fields, projection,
                                   [self.expr(k) for k in fexprs])
            return p.TableScan(F.s(s0), F.s(s1), self.fields(kids))
        if kind == _P_PROJECTION:
            nf = ival
            return p.Projection(self.plan(kids[0]),
                                [self.expr(k) for k in kids[1 + nf:]],
                                self.fields(kids[1:1 + nf]))
        if kind == _P_FILTER:
            nf = ival
            return p.Filter(self.plan(kids[0]), self.expr(kids[-1]),
                            self.fields(kids[1:1 + nf]))
        if kind == _P_JOIN:
            nf = ival
            has_resid = bool(flags & 1)
            fields = self.fields(kids[2:2 + nf])
            rest = kids[2 + nf:]
            resid = self.expr(rest[-1]) if has_resid else None
            pairs_ids = rest[:-1] if has_resid else rest
            on = [(self.expr(F.kids(pi)[0]), self.expr(F.kids(pi)[1]))
                  for pi in pairs_ids]
            return p.Join(self.plan(kids[0]), self.plan(kids[1]), F.s(s0),
                          on, resid, fields, null_aware=bool(flags & 2))
        if kind == _P_CROSSJOIN:
            return p.CrossJoin(self.plan(kids[0]), self.plan(kids[1]),
                               self.fields(kids[2:]))
        if kind == _P_AGGREGATE:
            nf = ival
            ngroups = flags
            fields = self.fields(kids[1:1 + nf])
            rest = kids[1 + nf:]
            return p.Aggregate(self.plan(kids[0]),
                               [self.expr(k) for k in rest[:ngroups]],
                               [self.expr(k) for k in rest[ngroups:]], fields)
        if kind == _P_WINDOW:
            nf = ival
            return p.Window(self.plan(kids[0]),
                            [self.expr(k) for k in kids[1 + nf:]],
                            self.fields(kids[1:1 + nf]))
        if kind == _P_SORT:
            nf = ival
            fetch = int(dval) if flags & 1 else None
            return p.Sort(self.plan(kids[0]),
                          [self.sortkey(k) for k in kids[1 + nf:]],
                          self.fields(kids[1:1 + nf]), fetch)
        if kind == _P_LIMIT:
            fetch = ival if flags & 1 else None
            skip = int(F.s(s0))
            return p.Limit(self.plan(kids[0]), skip, fetch,
                           self.fields(kids[1:]))
        if kind == _P_UNION:
            nf = ival
            return p.Union([self.plan(k) for k in kids[nf:]], bool(flags & 1),
                           self.fields(kids[:nf]))
        if kind == _P_INTERSECT:
            return p.Intersect(self.plan(kids[0]), self.plan(kids[1]),
                               bool(flags & 1), self.fields(kids[2:]))
        if kind == _P_EXCEPT:
            return p.Except(self.plan(kids[0]), self.plan(kids[1]),
                            bool(flags & 1), self.fields(kids[2:]))
        if kind == _P_DISTINCT:
            return p.Distinct(self.plan(kids[0]), self.fields(kids[1:]))
        if kind == _P_VALUES:
            nf = ival
            rows = [[self.expr(c) for c in F.kids(r)] for r in kids[nf:]]
            return p.Values(rows, self.fields(kids[:nf]))
        if kind == _P_EMPTY:
            return p.EmptyRelation(self.fields(kids), bool(flags & 1))
        if kind == _P_SUBQUERY_ALIAS:
            return p.SubqueryAlias(self.plan(kids[0]), F.s(s0),
                                   self.fields(kids[1:]))
        if kind == _P_SAMPLE:
            seed = ival if flags & 1 else None
            return p.Sample(self.plan(kids[0]), F.s(s0), dval, seed,
                            self.fields(kids[1:]))
        if kind == _P_DISTRIBUTE_BY:
            nf = ival
            return p.DistributeBy(self.plan(kids[0]),
                                  [self.expr(k) for k in kids[1 + nf:]],
                                  self.fields(kids[1:1 + nf]))
        if kind == _P_EXPLAIN:
            return p.Explain(self.plan(kids[0]), self.fields(kids[1:]),
                             bool(flags & 1), bool(flags & 2),
                             bool(flags & 4), bool(flags & 8))
        # ---- DDL / ML custom nodes ----
        ine = bool(flags & 1)
        orr = bool(flags & 2)
        if kind == _P_CREATE_TABLE:
            part_ids, rest = self._split(kids, _P_PART)
            return p.CreateTableNode([], self.parts(part_ids),
                                     self.kwargs(rest[0]), ine, orr)
        if kind == _P_CREATE_MEMORY_TABLE:
            nparts = ival
            return p.CreateMemoryTableNode([], self.parts(kids[:nparts]),
                                           self.plan(kids[nparts]),
                                           bool(flags & 4), ine, orr)
        if kind == _P_DROP_TABLE:
            return p.DropTableNode([], self.parts(kids), bool(flags & 1))
        if kind == _P_CREATE_SCHEMA:
            return p.CreateSchemaNode([], F.s(s0), ine, orr)
        if kind == _P_DROP_SCHEMA:
            return p.DropSchemaNode([], F.s(s0), bool(flags & 1))
        if kind == _P_USE_SCHEMA:
            return p.UseSchemaNode([], F.s(s0))
        if kind == _P_ALTER_SCHEMA:
            return p.AlterSchemaNode([], F.s(s0), F.s(s1))
        if kind == _P_ALTER_TABLE:
            return p.AlterTableNode([], self.parts(kids), F.s(s0),
                                    bool(flags & 1))
        if kind == _P_SHOW_SCHEMAS:
            like = F.s(s0) if flags & 1 else None
            return p.ShowSchemasNode(self.fields(kids), like)
        if kind == _P_SHOW_TABLES:
            sc = F.s(s0) if flags & 1 else None
            return p.ShowTablesNode(self.fields(kids), sc)
        if kind == _P_SHOW_COLUMNS:
            nf = ival
            return p.ShowColumnsNode(self.fields(kids[:nf]),
                                     self.parts(kids[nf:]))
        if kind == _P_SHOW_MODELS:
            sc = F.s(s0) if flags & 1 else None
            return p.ShowModelsNode(self.fields(kids), sc)
        if kind == _P_SHOW_METRICS:
            like = F.s(s0) if flags & 1 else None
            return p.ShowMetricsNode(self.fields(kids), like)
        if kind == _P_SHOW_PROFILES:
            like = F.s(s0) if flags & 1 else None
            return p.ShowProfilesNode(self.fields(kids), like)
        if kind == _P_SHOW_QUERIES:
            like = F.s(s0) if flags & 1 else None
            return p.ShowQueriesNode(self.fields(kids), like)
        if kind == _P_CANCEL_QUERY:
            return p.CancelQueryNode(self.fields(kids), F.s(s0) or "")
        if kind == _P_ANALYZE_TABLE:
            table = [F.s(F.nodes[i][4]) for i in kids if F.nodes[i][1] == 0]
            columns = [F.s(F.nodes[i][4]) for i in kids if F.nodes[i][1] == 1]
            return p.AnalyzeTableNode([], table, columns)
        if kind == _P_CREATE_MODEL:
            nparts = ival
            return p.CreateModelNode([], self.parts(kids[:nparts]),
                                     self.kwargs(kids[nparts]),
                                     self.plan(kids[nparts + 1]), ine, orr)
        if kind == _P_DROP_MODEL:
            return p.DropModelNode([], self.parts(kids), bool(flags & 1))
        if kind == _P_DESCRIBE_MODEL:
            nf = ival
            return p.DescribeModelNode(self.fields(kids[:nf]),
                                       self.parts(kids[nf:]))
        if kind == _P_EXPORT_MODEL:
            nparts = ival
            return p.ExportModelNode([], self.parts(kids[:nparts]),
                                     self.kwargs(kids[nparts]))
        if kind == _P_CREATE_EXPERIMENT:
            nparts = ival
            return p.CreateExperimentNode([], self.parts(kids[:nparts]),
                                          self.kwargs(kids[nparts]),
                                          self.plan(kids[nparts + 1]), ine, orr)
        if kind == _P_PREDICT_MODEL:
            nf = ival
            return p.PredictModelNode(self.fields(kids[1:1 + nf]),
                                      self.parts(kids[1 + nf:]),
                                      self.plan(kids[0]))
        raise ValueError(f"bad plan kind {kind}")


def native_bind(sql: str, catalog, cat_buf: Optional[bytes] = None,
                strict: bool = False):
    """Parse + bind via the C++ binder; returns a LogicalPlan, or None when
    the native path is unavailable / declines (Python binder fallback).
    Raises BindError for genuine bind errors — same exception surface as the
    Python binder.  A native-parser rejection (the Python parser already
    accepted this text upstream) falls back unless `strict`, where it raises
    ParsingException."""
    lib = _get_binder_lib()
    if lib is None:
        return None
    raw = sql.encode("utf-8")
    try:
        if cat_buf is None:
            cat_buf = encode_catalog(catalog)
    except KeyError:  # exotic type in a table/function signature
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    rc = lib.dsql_bind(raw, len(raw), cat_buf, len(cat_buf),
                       ctypes.byref(out), ctypes.byref(out_len))
    if rc == 1:
        return None
    try:
        buf = ctypes.string_at(out, out_len.value) if out_len.value else b""
    finally:
        if out:
            lib.dsql_buf_free(out)
    if rc == 2:
        from .binder import BindError

        msg = buf[1:].decode("utf-8", "replace")
        if buf[:1] == b"\x01":  # missing table/schema: KeyError surface
            raise KeyError(msg)
        raise BindError(msg)
    if rc == 3:
        if not strict:
            return None  # parser lockstep gap: Python binder handles it
        import struct

        from .parser import ParsingException

        pos = struct.unpack_from("<q", buf, 0)[0]
        msg = buf[8:].decode("utf-8", "replace")
        ctx = sql[max(0, pos - 30): pos + 30]
        raise ParsingException(f"{msg} at position {pos} (near {ctx!r})")
    try:
        f = _FlatPlan(buf)
        return _PlanDecoder(f).plan(f.root)
    except Exception:  # dsql: allow-broad-except — corrupt buffer -> Python fallback
        logger.debug("native plan decode failed", exc_info=True)
        return None


# ---------------------------------------------------------------------------
# native planner: parse + bind + structural-optimize in one call
# ---------------------------------------------------------------------------
_planner_checked = False
_planner_ok = False


def _get_planner_lib():
    global _planner_checked, _planner_ok
    lib = _get_binder_lib()
    if lib is None:
        return None
    if not _planner_checked:
        _planner_checked = True
        try:
            lib.dsql_plan.restype = ctypes.c_int32
            lib.dsql_plan.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_double,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.dsql_optimizer_abi_version.restype = ctypes.c_int32
            _planner_ok = lib.dsql_optimizer_abi_version() == 6
        except AttributeError:
            _planner_ok = False
    return lib if _planner_ok else None


def native_plan(sql: str, catalog, cat_buf: Optional[bytes] = None,
                predicate_pushdown: bool = True, strict: bool = False,
                reorder: bool = True, fact_dimension_ratio: float = 0.7,
                max_fact_tables: int = 2, preserve_user_order: bool = True,
                filter_selectivity: float = 1.0):
    """Parse + bind + run the core optimizer rule pipeline natively
    (native/binder.cpp Optimizer — the analogue of the reference's compiled
    DataFusion rule loop, optimizer.rs:53-98).  Returns the optimized
    LogicalPlan or None for Python fallback; join reordering / DPP /
    embedded-subquery passes run in Python on the decoded plan."""
    lib = _get_planner_lib()
    if lib is None:
        return None
    raw = sql.encode("utf-8")
    try:
        if cat_buf is None:
            cat_buf = encode_catalog(catalog)
    except KeyError:
        return None
    if cat_buf is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_int64()
    rc = lib.dsql_plan(raw, len(raw), cat_buf, len(cat_buf),
                       1 if predicate_pushdown else 0,
                       1 if reorder else 0,
                       float(fact_dimension_ratio), int(max_fact_tables),
                       1 if preserve_user_order else 0,
                       float(filter_selectivity),
                       ctypes.byref(out), ctypes.byref(out_len))
    if rc == 1:
        return None
    try:
        buf = ctypes.string_at(out, out_len.value) if out_len.value else b""
    finally:
        if out:
            lib.dsql_buf_free(out)
    if rc == 2:
        from .binder import BindError

        msg = buf[1:].decode("utf-8", "replace")
        if buf[:1] == b"\x01":
            raise KeyError(msg)
        raise BindError(msg)
    if rc == 3:
        if not strict:
            return None
        import struct

        from .parser import ParsingException

        pos = struct.unpack_from("<q", buf, 0)[0]
        msg = buf[8:].decode("utf-8", "replace")
        ctx = sql[max(0, pos - 30): pos + 30]
        raise ParsingException(f"{msg} at position {pos} (near {ctx!r})")
    try:
        f = _FlatPlan(buf)
        return _PlanDecoder(f).plan(f.root)
    except Exception:  # dsql: allow-broad-except — corrupt buffer -> Python fallback
        logger.debug("native plan decode failed", exc_info=True)
        return None
