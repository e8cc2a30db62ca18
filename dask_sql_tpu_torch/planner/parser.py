"""SQL parser: tokens -> AST.

Copied from `dask_sql_tpu/planner/parser.py`; only import paths differ.

Role parity: reference `src/parser.rs` (`DaskParser::parse_sql`, parser.rs:400) —
standard SQL plus the dask dialect statements (`CREATE MODEL/EXPERIMENT`,
`PREDICT`, `EXPORT MODEL`, `SHOW ...`, `DESCRIBE MODEL`, `ANALYZE TABLE`,
`ALTER`, `USE SCHEMA`, `CREATE TABLE ... WITH(...)`, parser.rs:552-1350) and the
dialect conveniences of `src/dialect.rs` (`CEIL(x TO DAY)`, `FILTER (WHERE ...)`
aggregates, `TIMESTAMPADD`, ...).  Hand-written recursive descent with Pratt
expression parsing.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

from . import sqlast as a
from ..resilience.errors import ParseError
from .lexer import Token, TokenType, tokenize

logger = logging.getLogger(__name__)


class ParsingException(ParseError):
    """Parity: reference DFParsingException (src/error.rs).  Based on the
    resilience taxonomy (code PARSE_ERROR, USER_ERROR, never retryable) so
    the server emits a structured wire payload; still a ValueError through
    ParseError for historical callers."""


RESERVED_STOP = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "UNION",
    "INTERSECT", "EXCEPT", "ON", "USING", "JOIN", "INNER", "LEFT", "RIGHT",
    "FULL", "CROSS", "AS", "AND", "OR", "NOT", "WHEN", "THEN", "ELSE", "END",
    "BY", "ASC", "DESC", "NULLS", "SELECT", "SEMI", "ANTI", "DISTRIBUTE",
    "WITH", "TABLESAMPLE", "FETCH", "WINDOW", "OUTER", "NATURAL", "FILTER",
    "OVER", "CASE", "BETWEEN", "IN", "LIKE", "ILIKE", "SIMILAR", "IS", "ESCAPE",
    "VALUES", "TO", "FOR",
}

_DATETIME_UNITS = {
    "YEAR", "QUARTER", "MONTH", "WEEK", "DAY", "DOW", "DOY", "HOUR", "MINUTE",
    "SECOND", "MILLISECOND", "MICROSECOND", "NANOSECOND", "EPOCH", "CENTURY",
    "DECADE", "MILLENNIUM", "ISODOW", "ISOYEAR",
}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.tokens = self._tokenize(sql)
        self.pos = 0

    @staticmethod
    def _tokenize(sql: str):
        # native (C++) lexer when built, identical-contract Python fallback
        try:
            from .native_bridge import native_tokenize

            tokens = native_tokenize(sql)
            if tokens is not None:
                return tokens
        except Exception:  # dsql: allow-broad-except — fall back on any native issue
            pass
        return tokenize(sql)

    # -- token helpers ------------------------------------------------------
    def peek(self, offset: int = 0) -> Token:
        i = min(self.pos + offset, len(self.tokens) - 1)
        return self.tokens[i]

    def next(self) -> Token:
        tok = self.tokens[self.pos]
        if tok.type != TokenType.EOF:
            self.pos += 1
        return tok

    def error(self, msg: str) -> ParsingException:
        tok = self.peek()
        ctx = self.sql[max(0, tok.pos - 30) : tok.pos + 30]
        return ParsingException(f"{msg} at position {tok.pos} (near {ctx!r})")

    def at_keyword(self, *kws: str) -> bool:
        tok = self.peek()
        return tok.type == TokenType.IDENT and tok.upper in kws

    def accept_keyword(self, *kws: str) -> bool:
        if self.at_keyword(*kws):
            self.next()
            return True
        return False

    def expect_keyword(self, kw: str) -> None:
        if not self.accept_keyword(kw):
            raise self.error(f"Expected {kw}")

    def accept(self, value: str) -> bool:
        tok = self.peek()
        if tok.type in (TokenType.OP, TokenType.PUNCT) and tok.value == value:
            self.next()
            return True
        return False

    def expect(self, value: str) -> None:
        if not self.accept(value):
            raise self.error(f"Expected {value!r}")

    def parse_identifier(self) -> str:
        tok = self.peek()
        if tok.type == TokenType.QUOTED_IDENT:
            self.next()
            return tok.value
        if tok.type == TokenType.IDENT:
            self.next()
            return tok.value
        raise self.error("Expected identifier")

    def parse_qualified_name(self) -> List[str]:
        parts = [self.parse_identifier()]
        while self.accept("."):
            parts.append(self.parse_identifier())
        return parts

    # -- statements ---------------------------------------------------------
    def parse_statements(self) -> List[a.Statement]:
        stmts = []
        while self.peek().type != TokenType.EOF:
            stmts.append(self.parse_statement())
            while self.accept(";"):
                pass
        return stmts

    def parse_statement(self) -> a.Statement:
        if self.at_keyword("SELECT", "WITH", "VALUES") or self.peek().value == "(":
            return a.QueryStatement(self.parse_query())
        if self.at_keyword("EXPLAIN"):
            self.next()
            analyze = self.accept_keyword("ANALYZE")
            lint = False if analyze else self.accept_keyword("LINT")
            estimate = False if (analyze or lint) \
                else self.accept_keyword("ESTIMATE")
            fmt_json = False
            if self.accept_keyword("FORMAT"):
                self.expect_keyword("JSON")
                if not analyze:
                    # reject now rather than silently return text a JSON
                    # client would choke on: only ANALYZE produces the
                    # Chrome-trace payload
                    raise self.error("FORMAT JSON requires EXPLAIN ANALYZE")
                fmt_json = True
            self.accept_keyword("VERBOSE")
            return a.ExplainStatement(self.parse_query(), analyze, lint,
                                      estimate, fmt_json)
        if self.at_keyword("CREATE"):
            return self.parse_create()
        if self.at_keyword("DROP"):
            return self.parse_drop()
        if self.at_keyword("SHOW"):
            return self.parse_show()
        if self.at_keyword("DESCRIBE", "DESC"):
            self.next()
            if self.accept_keyword("MODEL"):
                return a.DescribeModel(self.parse_qualified_name())
            return a.ShowColumns(self.parse_qualified_name())
        if self.at_keyword("ANALYZE"):
            self.next()
            self.expect_keyword("TABLE")
            table = self.parse_qualified_name()
            self.expect_keyword("COMPUTE")
            self.expect_keyword("STATISTICS")
            cols: List[str] = []
            if self.accept_keyword("FOR"):
                if self.accept_keyword("ALL"):
                    self.expect_keyword("COLUMNS")
                else:
                    self.expect_keyword("COLUMNS")
                    cols.append(self.parse_identifier())
                    while self.accept(","):
                        cols.append(self.parse_identifier())
            return a.AnalyzeTable(table, cols)
        if self.at_keyword("USE"):
            self.next()
            self.expect_keyword("SCHEMA")
            return a.UseSchema(self.parse_identifier())
        if self.at_keyword("ALTER"):
            return self.parse_alter()
        if self.at_keyword("CANCEL"):
            self.next()
            self.expect_keyword("QUERY")
            # the qid is a string literal ('uuid'); a bare identifier is
            # accepted too so copy-pasting an unquoted qid still works
            return a.CancelQuery(self.next().value)
        if self.at_keyword("EXPORT"):
            self.next()
            self.expect_keyword("MODEL")
            name = self.parse_qualified_name()
            self.expect_keyword("WITH")
            kwargs = self.parse_kwargs()
            return a.ExportModel(name, kwargs)
        if self.at_keyword("INSERT"):
            self.next()
            self.expect_keyword("INTO")
            name = self.parse_qualified_name()
            # the body is any query: VALUES (...), (...) or a full SELECT
            return a.InsertInto(name, self.parse_query())
        raise self.error("Unsupported statement")

    def parse_create(self) -> a.Statement:
        self.expect_keyword("CREATE")
        or_replace = False
        if self.accept_keyword("OR"):
            self.expect_keyword("REPLACE")
            or_replace = True
        if self.accept_keyword("SCHEMA"):
            ine = self._if_not_exists()
            return a.CreateSchema(self.parse_identifier(), ine, or_replace)
        if self.accept_keyword("MODEL"):
            ine = self._if_not_exists()
            name = self.parse_qualified_name()
            self.expect_keyword("WITH")
            kwargs = self.parse_kwargs()
            self.expect_keyword("AS")
            self.accept("(")
            query = self.parse_query()
            self.accept(")")
            return a.CreateModel(name, kwargs, query, ine, or_replace)
        if self.accept_keyword("EXPERIMENT"):
            ine = self._if_not_exists()
            name = self.parse_qualified_name()
            self.expect_keyword("WITH")
            kwargs = self.parse_kwargs()
            self.expect_keyword("AS")
            self.accept("(")
            query = self.parse_query()
            self.accept(")")
            return a.CreateExperiment(name, kwargs, query, ine, or_replace)
        is_view = self.accept_keyword("VIEW")
        if not is_view:
            self.expect_keyword("TABLE")
        ine = self._if_not_exists()
        name = self.parse_qualified_name()
        if self.accept_keyword("WITH"):
            kwargs = self.parse_kwargs()
            return a.CreateTableWith(name, kwargs, ine, or_replace)
        if self.accept_keyword("AS"):
            self.accept("(")
            query = self.parse_query()
            self.accept(")")
            return a.CreateTableAs(name, query, persist=not is_view,
                                   if_not_exists=ine, or_replace=or_replace)
        raise self.error("Expected WITH (...) or AS (...) in CREATE TABLE")

    def _if_not_exists(self) -> bool:
        if self.accept_keyword("IF"):
            self.expect_keyword("NOT")
            self.expect_keyword("EXISTS")
            return True
        return False

    def parse_drop(self) -> a.Statement:
        self.expect_keyword("DROP")
        if self.accept_keyword("SCHEMA"):
            ie = self._if_exists()
            return a.DropSchema(self.parse_identifier(), ie)
        if self.accept_keyword("MODEL"):
            ie = self._if_exists()
            return a.DropModel(self.parse_qualified_name(), ie)
        if self.accept_keyword("TABLE") or self.accept_keyword("VIEW"):
            ie = self._if_exists()
            return a.DropTable(self.parse_qualified_name(), ie)
        raise self.error("Expected TABLE, VIEW, SCHEMA or MODEL after DROP")

    def _if_exists(self) -> bool:
        if self.accept_keyword("IF"):
            self.expect_keyword("EXISTS")
            return True
        return False

    def parse_show(self) -> a.Statement:
        self.expect_keyword("SHOW")
        if self.accept_keyword("SCHEMAS"):
            like = None
            if self.accept_keyword("LIKE"):
                like = self.next().value
            return a.ShowSchemas(like)
        if self.accept_keyword("TABLES"):
            schema = None
            if self.accept_keyword("FROM") or self.accept_keyword("IN"):
                schema = self.parse_identifier()
            return a.ShowTables(schema)
        if self.accept_keyword("COLUMNS"):
            self.expect_keyword("FROM")
            return a.ShowColumns(self.parse_qualified_name())
        if self.accept_keyword("MODELS"):
            schema = None
            if self.accept_keyword("FROM") or self.accept_keyword("IN"):
                schema = self.parse_identifier()
            return a.ShowModels(schema)
        if self.accept_keyword("METRICS"):
            like = None
            if self.accept_keyword("LIKE"):
                like = self.next().value
            return a.ShowMetrics(like)
        if self.accept_keyword("PROFILES"):
            like = None
            if self.accept_keyword("LIKE"):
                like = self.next().value
            return a.ShowProfiles(like)
        if self.accept_keyword("QUERIES"):
            like = None
            if self.accept_keyword("LIKE"):
                like = self.next().value
            return a.ShowQueries(like)
        if self.accept_keyword("MATERIALIZED"):
            like = None
            if self.accept_keyword("LIKE"):
                like = self.next().value
            return a.ShowMaterialized(like)
        if self.accept_keyword("REPLICAS"):
            like = None
            if self.accept_keyword("LIKE"):
                like = self.next().value
            return a.ShowReplicas(like)
        raise self.error(
            "Expected SCHEMAS, TABLES, COLUMNS, MODELS, METRICS, PROFILES, "
            "QUERIES, MATERIALIZED or REPLICAS after SHOW")

    def parse_alter(self) -> a.Statement:
        self.expect_keyword("ALTER")
        if self.accept_keyword("SCHEMA"):
            old = self.parse_identifier()
            self.expect_keyword("RENAME")
            self.expect_keyword("TO")
            return a.AlterSchema(old, self.parse_identifier())
        self.expect_keyword("TABLE")
        ie = self._if_exists()
        old = self.parse_qualified_name()
        self.expect_keyword("RENAME")
        self.expect_keyword("TO")
        return a.AlterTable(old, self.parse_identifier(), ie)

    def parse_kwargs(self) -> Dict[str, Any]:
        """WITH ( key = value, ... ) — values: literal, ident, list, nested map."""
        self.expect("(")
        kwargs: Dict[str, Any] = {}
        if not self.accept(")"):
            while True:
                key = self.parse_identifier()
                self.expect("=")
                kwargs[key] = self.parse_kwarg_value()
                if not self.accept(","):
                    break
            self.expect(")")
        return kwargs

    def parse_kwarg_value(self):
        tok = self.peek()
        if tok.type == TokenType.STRING:
            self.next()
            return tok.value
        if tok.type == TokenType.NUMBER:
            self.next()
            return _parse_number(tok.value)
        if self.accept("("):  # nested map or list
            if self.peek(1).value == "=" and self.peek().type in (TokenType.IDENT, TokenType.QUOTED_IDENT):
                self.pos -= 1
                return self.parse_kwargs()
            items = []
            if not self.accept(")"):
                while True:
                    items.append(self.parse_kwarg_value())
                    if not self.accept(","):
                        break
                self.expect(")")
            return items
        if self.accept("["):
            items = []
            if not self.accept("]"):
                while True:
                    items.append(self.parse_kwarg_value())
                    if not self.accept(","):
                        break
                self.expect("]")
            return items
        if tok.type == TokenType.IDENT:
            self.next()
            up = tok.upper
            if up == "TRUE":
                return True
            if up == "FALSE":
                return False
            if up == "NULL":
                return None
            return tok.value
        raise self.error("Expected kwarg value")

    # -- queries ------------------------------------------------------------
    def parse_query(self) -> a.Select:
        ctes: List[Tuple[str, a.Select]] = []
        if self.accept_keyword("WITH"):
            while True:
                name = self.parse_identifier()
                self.expect_keyword("AS")
                self.expect("(")
                sub = self.parse_query()
                self.expect(")")
                ctes.append((name, sub))
                if not self.accept(","):
                    break
        query = self.parse_set_expr()
        query.ctes = ctes + query.ctes
        # trailing ORDER BY / LIMIT apply to the whole set expression
        if self.accept_keyword("ORDER"):
            self.expect_keyword("BY")
            query.order_by = self.parse_order_items()
        if self.accept_keyword("LIMIT"):
            tok = self.next()
            if tok.upper == "ALL":
                pass
            else:
                query.limit = int(_parse_number(tok.value))
        if self.accept_keyword("OFFSET"):
            query.offset = int(_parse_number(self.next().value))
            self.accept_keyword("ROW") or self.accept_keyword("ROWS")
        if self.accept_keyword("FETCH"):
            self.accept_keyword("FIRST") or self.accept_keyword("NEXT")
            query.limit = int(_parse_number(self.next().value))
            self.accept_keyword("ROW") or self.accept_keyword("ROWS")
            self.expect_keyword("ONLY")
        return query

    def parse_set_expr(self) -> a.Select:
        left = self.parse_select_core()
        while self.at_keyword("UNION", "INTERSECT", "EXCEPT"):
            op = self.next().upper
            all_ = self.accept_keyword("ALL")
            if not all_:
                self.accept_keyword("DISTINCT")
            right = self.parse_select_core()
            if left.set_op is not None:
                # chain: wrap the existing (A op B) as a derived table
                prev = left
                left = a.Select(projections=[a.SelectItem(a.Wildcard())],
                                from_=a.DerivedTable(prev, alias=None))
            left.set_op = (op, all_, right)
        return left

    def parse_select_core(self) -> a.Select:
        if self.accept("("):
            q = self.parse_query()
            self.expect(")")
            return q
        sel = a.Select()
        if self.accept_keyword("VALUES"):
            rows = []
            while True:
                self.expect("(")
                row = [self.parse_expr()]
                while self.accept(","):
                    row.append(self.parse_expr())
                self.expect(")")
                rows.append(row)
                if not self.accept(","):
                    break
            sel.values = rows
            return sel
        self.expect_keyword("SELECT")
        if self.accept_keyword("DISTINCT"):
            sel.distinct = True
        else:
            self.accept_keyword("ALL")
        sel.projections = self.parse_projections()
        if self.accept_keyword("FROM"):
            sel.from_ = self.parse_table_ref()
        if self.accept_keyword("WHERE"):
            sel.where = self.parse_expr()
        if self.at_keyword("GROUP"):
            self.next()
            self.expect_keyword("BY")
            sel.group_by = [self._parse_group_item()]
            while self.accept(","):
                sel.group_by.append(self._parse_group_item())
        if self.accept_keyword("HAVING"):
            sel.having = self.parse_expr()
        if self.at_keyword("WINDOW") and self.peek(1).type in (
                TokenType.IDENT, TokenType.QUOTED_IDENT) \
                and self.peek(2).upper == "AS":
            self.next()
            while True:
                wname = self.parse_identifier()
                self.expect_keyword("AS")
                sel.named_windows[wname] = self._parse_window_spec()
                if not self.accept(","):
                    break
        if self.at_keyword("DISTRIBUTE"):
            self.next()
            self.expect_keyword("BY")
            sel.distribute_by = [self.parse_expr()]
            while self.accept(","):
                sel.distribute_by.append(self.parse_expr())
        return sel

    def _parse_group_item(self) -> a.Expr:
        if self.at_keyword("GROUPING") and self.peek(1).upper == "SETS":
            self.next()
            self.next()
            self.expect("(")
            sets = []
            while True:
                if self.accept("("):
                    items = []
                    if not self.accept(")"):
                        items.append(self.parse_expr())
                        while self.accept(","):
                            items.append(self.parse_expr())
                        self.expect(")")
                    sets.append(items)
                else:
                    sets.append([self.parse_expr()])
                if not self.accept(","):
                    break
            self.expect(")")
            return a.GroupingSets(sets)
        if self.at_keyword("ROLLUP") and self.peek(1).value == "(":
            self.next()
            self.expect("(")
            exprs = [self.parse_expr()]
            while self.accept(","):
                exprs.append(self.parse_expr())
            self.expect(")")
            return a.Rollup(exprs)
        if self.at_keyword("CUBE") and self.peek(1).value == "(":
            self.next()
            self.expect("(")
            exprs = [self.parse_expr()]
            while self.accept(","):
                exprs.append(self.parse_expr())
            self.expect(")")
            return a.Cube(exprs)
        return self.parse_expr()

    def parse_projections(self) -> List[a.SelectItem]:
        items = [self.parse_select_item()]
        while self.accept(","):
            items.append(self.parse_select_item())
        return items

    def parse_select_item(self) -> a.SelectItem:
        expr = self.parse_expr()
        alias = None
        if self.accept_keyword("AS"):
            alias = self.parse_identifier()
        elif self.peek().type in (TokenType.IDENT, TokenType.QUOTED_IDENT) and self.peek().upper not in RESERVED_STOP:
            alias = self.parse_identifier()
        return a.SelectItem(expr, alias)

    def parse_order_items(self) -> List[a.OrderItem]:
        items = [self.parse_order_item()]
        while self.accept(","):
            items.append(self.parse_order_item())
        return items

    def parse_order_item(self) -> a.OrderItem:
        expr = self.parse_expr()
        asc = True
        if self.accept_keyword("ASC"):
            asc = True
        elif self.accept_keyword("DESC"):
            asc = False
        nulls_first = None
        if self.accept_keyword("NULLS"):
            if self.accept_keyword("FIRST"):
                nulls_first = True
            else:
                self.expect_keyword("LAST")
                nulls_first = False
        return a.OrderItem(expr, asc, nulls_first)

    # -- FROM clause --------------------------------------------------------
    def parse_table_ref(self) -> a.TableRef:
        left = self.parse_table_factor()
        while True:
            natural = self.accept_keyword("NATURAL")
            if self.accept_keyword("CROSS"):
                self.expect_keyword("JOIN")
                right = self.parse_table_factor()
                left = a.Join(left, right, "CROSS")
                continue
            join_type = None
            if self.accept_keyword("INNER"):
                join_type = "INNER"
            elif self.at_keyword("LEFT", "RIGHT", "FULL"):
                jt = self.next().upper
                if jt == "LEFT" and self.accept_keyword("SEMI"):
                    join_type = "LEFTSEMI"
                elif jt == "LEFT" and self.accept_keyword("ANTI"):
                    join_type = "LEFTANTI"
                else:
                    self.accept_keyword("OUTER")
                    join_type = jt
            elif self.at_keyword("JOIN"):
                join_type = "INNER"
            if join_type is None:
                if self.accept(","):
                    right = self.parse_table_factor()
                    left = a.Join(left, right, "CROSS")
                    continue
                break
            self.expect_keyword("JOIN")
            right = self.parse_table_factor()
            condition, using = None, None
            if self.accept_keyword("ON"):
                condition = self.parse_expr()
            elif self.accept_keyword("USING"):
                self.expect("(")
                using = [self.parse_identifier()]
                while self.accept(","):
                    using.append(self.parse_identifier())
                self.expect(")")
            elif natural:
                using = []  # natural join: resolved in binder
            left = a.Join(left, right, join_type, condition, using)
        return left

    def parse_table_factor(self) -> a.TableRef:
        if self.accept("("):
            inner = self.parse_query() if self.at_keyword("SELECT", "WITH", "VALUES") or self.peek().value == "(" else None
            if inner is None:
                ref = self.parse_table_ref()
                self.expect(")")
                return ref
            self.expect(")")
            alias = self._parse_table_alias()
            return a.DerivedTable(inner, alias)
        if self.at_keyword("PREDICT") and self.peek(1).value == "(":
            self.next()
            self.expect("(")
            self.expect_keyword("MODEL")
            model = self.parse_qualified_name()
            self.expect(",")
            query = self.parse_query()
            self.expect(")")
            alias = self._parse_table_alias()
            return a.TableFunction("PREDICT", model, query, alias)
        parts = self.parse_qualified_name()
        sample = None
        if self.accept_keyword("TABLESAMPLE"):
            method = "BERNOULLI"
            if self.accept_keyword("SYSTEM"):
                method = "SYSTEM"
            elif self.accept_keyword("BERNOULLI"):
                method = "BERNOULLI"
            self.expect("(")
            frac = float(_parse_number(self.next().value))
            self.expect(")")
            seed = None
            if self.accept_keyword("REPEATABLE"):
                self.expect("(")
                seed = int(_parse_number(self.next().value))
                self.expect(")")
            sample = (method, frac, seed)
        alias = self._parse_table_alias()
        return a.NamedTable(parts, alias, sample)

    def _parse_table_alias(self) -> Optional[str]:
        if self.accept_keyword("AS"):
            alias = self.parse_identifier()
        elif self.peek().type in (TokenType.IDENT, TokenType.QUOTED_IDENT) and self.peek().upper not in RESERVED_STOP:
            alias = self.parse_identifier()
        else:
            return None
        if self.accept("("):  # column aliases: t(a, b) — consumed, applied in binder
            cols = [self.parse_identifier()]
            while self.accept(","):
                cols.append(self.parse_identifier())
            self.expect(")")
            return (alias, cols)  # type: ignore[return-value]
        return alias

    # -- expressions (Pratt) ------------------------------------------------
    def parse_expr(self) -> a.Expr:
        return self.parse_or()

    def parse_or(self) -> a.Expr:
        left = self.parse_and()
        while self.accept_keyword("OR"):
            left = a.BinaryOp("OR", left, self.parse_and())
        return left

    def parse_and(self) -> a.Expr:
        left = self.parse_not()
        while self.accept_keyword("AND"):
            left = a.BinaryOp("AND", left, self.parse_not())
        return left

    def parse_not(self) -> a.Expr:
        if self.accept_keyword("NOT"):
            return a.UnaryOp("NOT", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> a.Expr:
        left = self.parse_comparison()
        while True:
            negated = False
            save = self.pos
            if self.accept_keyword("NOT"):
                negated = True
            if self.accept_keyword("BETWEEN"):
                symmetric = self.accept_keyword("SYMMETRIC")
                low = self.parse_comparison()
                self.expect_keyword("AND")
                high = self.parse_comparison()
                left = a.Between(left, low, high, negated, symmetric)
                continue
            if self.accept_keyword("IN"):
                self.expect("(")
                if self.at_keyword("SELECT", "WITH"):
                    sub = self.parse_query()
                    self.expect(")")
                    left = a.InSubquery(left, sub, negated)
                else:
                    items = [self.parse_expr()]
                    while self.accept(","):
                        items.append(self.parse_expr())
                    self.expect(")")
                    left = a.InList(left, items, negated)
                continue
            if self.at_keyword("LIKE", "ILIKE"):
                ci = self.next().upper == "ILIKE"
                pattern = self.parse_comparison()
                escape = None
                if self.accept_keyword("ESCAPE"):
                    escape = self.next().value
                left = a.Like(left, pattern, negated, ci, False, escape)
                continue
            if self.accept_keyword("SIMILAR"):
                self.expect_keyword("TO")
                pattern = self.parse_comparison()
                escape = None
                if self.accept_keyword("ESCAPE"):
                    escape = self.next().value
                left = a.Like(left, pattern, negated, False, True, escape)
                continue
            if negated:
                self.pos = save
                break
            if self.accept_keyword("IS"):
                neg = self.accept_keyword("NOT")
                if self.accept_keyword("NULL"):
                    left = a.IsNull(left, neg)
                elif self.accept_keyword("TRUE"):
                    left = a.IsBool(left, True, neg)
                elif self.accept_keyword("FALSE"):
                    left = a.IsBool(left, False, neg)
                elif self.accept_keyword("UNKNOWN"):
                    left = a.IsNull(left, neg)
                elif self.accept_keyword("DISTINCT"):
                    self.expect_keyword("FROM")
                    right = self.parse_comparison()
                    left = a.IsDistinctFrom(left, right, neg)
                else:
                    raise self.error("Expected NULL/TRUE/FALSE/DISTINCT FROM after IS")
                continue
            break
        return left

    def parse_comparison(self) -> a.Expr:
        left = self.parse_additive()
        tok = self.peek()
        if tok.type == TokenType.OP and tok.value in ("=", "<>", "!=", "<", "<=", ">", ">="):
            op = self.next().value
            if op == "!=":
                op = "<>"
            # ANY/ALL subquery comparison
            if self.at_keyword("ANY", "SOME", "ALL"):
                quant = self.next().upper
                self.expect("(")
                sub = self.parse_query()
                self.expect(")")
                if op == "=" and quant in ("ANY", "SOME"):
                    return a.InSubquery(left, sub, False)
                if op == "<>" and quant == "ALL":
                    return a.InSubquery(left, sub, True)
                raise self.error(f"Unsupported quantified comparison {op} {quant}")
            right = self.parse_additive()
            return a.BinaryOp(op, left, right)
        return left

    def parse_additive(self) -> a.Expr:
        left = self.parse_multiplicative()
        while True:
            tok = self.peek()
            if tok.type == TokenType.OP and tok.value in ("+", "-", "||"):
                op = self.next().value
                left = a.BinaryOp(op, left, self.parse_multiplicative())
            else:
                break
        return left

    def parse_multiplicative(self) -> a.Expr:
        left = self.parse_unary()
        while True:
            tok = self.peek()
            if tok.type == TokenType.OP and tok.value in ("*", "/", "%"):
                op = self.next().value
                left = a.BinaryOp(op, left, self.parse_unary())
            else:
                break
        return left

    def parse_unary(self) -> a.Expr:
        tok = self.peek()
        if tok.type == TokenType.OP and tok.value in ("-", "+"):
            self.next()
            operand = self.parse_unary()
            if tok.value == "-":
                if isinstance(operand, a.Literal) and isinstance(operand.value, (int, float)):
                    return a.Literal(-operand.value)
                return a.UnaryOp("-", operand)
            return operand
        return self.parse_postfix()

    def parse_postfix(self) -> a.Expr:
        expr = self.parse_primary()
        while True:
            if self.accept("::"):
                type_name = self._parse_type_name()
                expr = a.Cast(expr, type_name)
                continue
            break
        return expr

    def _parse_type_name(self) -> str:
        name = self.parse_identifier().upper()
        # multi-word types
        while self.peek().type == TokenType.IDENT and self.peek().upper in (
            "PRECISION", "VARYING", "WITHOUT", "WITH", "TIME", "ZONE", "LOCAL",
        ):
            name += " " + self.next().upper
        if self.accept("("):
            args = [self.next().value]
            while self.accept(","):
                args.append(self.next().value)
            self.expect(")")
            name += f"({','.join(args)})"
        return name

    # -- primary expressions -------------------------------------------------
    def parse_primary(self) -> a.Expr:
        tok = self.peek()
        if tok.type == TokenType.NUMBER:
            self.next()
            return a.Literal(_parse_number(tok.value))
        if tok.type == TokenType.STRING:
            self.next()
            return a.Literal(tok.value)
        if tok.type == TokenType.PARAM:
            self.next()
            return a.Literal(None)
        if tok.value == "(":
            self.next()
            if self.at_keyword("SELECT", "WITH"):
                sub = self.parse_query()
                self.expect(")")
                return a.ScalarSubquery(sub)
            expr = self.parse_expr()
            if self.accept(","):  # row constructor — treat as function ROW
                items = [expr, self.parse_expr()]
                while self.accept(","):
                    items.append(self.parse_expr())
                self.expect(")")
                return a.FunctionCall("ROW", items)
            self.expect(")")
            return expr
        if tok.value == "*":
            self.next()
            return a.Wildcard()
        if tok.type == TokenType.QUOTED_IDENT:
            return self._parse_identifier_chain()
        if tok.type != TokenType.IDENT:
            raise self.error("Expected expression")
        up = tok.upper
        # keyword literals & special forms
        if up == "NULL":
            self.next()
            return a.Literal(None)
        if up == "TRUE":
            self.next()
            return a.Literal(True)
        if up == "FALSE":
            self.next()
            return a.Literal(False)
        if up in ("DATE", "TIMESTAMP", "TIME") and self.peek(1).type == TokenType.STRING:
            self.next()
            val = self.next().value
            return a.Literal(val, type_name=up)
        if up == "INTERVAL":
            self.next()
            neg = self.accept("-")
            val_tok = self.next()
            value = val_tok.value
            unit = "SECOND"
            if self.peek().type == TokenType.IDENT and self.peek().upper.rstrip("S") in _DATETIME_UNITS:
                unit = self.next().upper.rstrip("S")
                if self.accept_keyword("TO"):
                    unit += " TO " + self.next().upper.rstrip("S")
            return a.IntervalLiteral(("-" if neg else "") + value, unit)
        if up == "CASE":
            return self._parse_case()
        if up == "CAST" or up == "TRY_CAST":
            self.next()
            self.expect("(")
            operand = self.parse_expr()
            self.expect_keyword("AS")
            type_name = self._parse_type_name()
            self.expect(")")
            return a.Cast(operand, type_name, safe=(up == "TRY_CAST"))
        if up == "EXTRACT":
            self.next()
            self.expect("(")
            unit = self.next().upper if self.peek().type == TokenType.IDENT else self.next().value.upper()
            self.expect_keyword("FROM")
            operand = self.parse_expr()
            self.expect(")")
            return a.Extract(unit, operand)
        if up == "SUBSTRING" and self.peek(1).value == "(":
            self.next()
            self.expect("(")
            operand = self.parse_expr()
            start, length = None, None
            if self.accept_keyword("FROM"):
                start = self.parse_expr()
                if self.accept_keyword("FOR"):
                    length = self.parse_expr()
            elif self.accept(","):
                start = self.parse_expr()
                if self.accept(","):
                    length = self.parse_expr()
            self.expect(")")
            return a.Substring(operand, start, length)
        if up == "TRIM" and self.peek(1).value == "(":
            self.next()
            self.expect("(")
            where = "BOTH"
            if self.at_keyword("LEADING", "TRAILING", "BOTH"):
                where = self.next().upper
            chars = None
            if self.peek().type == TokenType.STRING:
                chars = a.Literal(self.next().value)
                if self.accept_keyword("FROM"):
                    operand = self.parse_expr()
                else:
                    operand, chars = chars, None
            elif self.accept_keyword("FROM"):
                operand = self.parse_expr()
            else:
                operand = self.parse_expr()
                if self.accept_keyword("FROM"):
                    chars, operand = operand, self.parse_expr()
            self.expect(")")
            return a.Trim(operand, where, chars)
        if up == "POSITION" and self.peek(1).value == "(":
            self.next()
            self.expect("(")
            needle = self.parse_additive()  # stop before IN (it's the separator here)
            self.expect_keyword("IN")
            haystack = self.parse_expr()
            self.expect(")")
            return a.Position(needle, haystack)
        if up == "OVERLAY" and self.peek(1).value == "(":
            self.next()
            self.expect("(")
            operand = self.parse_expr()
            self.expect_keyword("PLACING")
            repl = self.parse_expr()
            self.expect_keyword("FROM")
            start = self.parse_expr()
            length = None
            if self.accept_keyword("FOR"):
                length = self.parse_expr()
            self.expect(")")
            return a.Overlay(operand, repl, start, length)
        if up in ("CEIL", "CEILING", "FLOOR") and self.peek(1).value == "(":
            # possible CEIL(x TO DAY) form (reference dialect.rs:48)
            save = self.pos
            self.next()
            self.expect("(")
            operand = self.parse_expr()
            if self.accept_keyword("TO"):
                unit = self.next().upper
                self.expect(")")
                return a.CeilFloorTo("CEIL" if up != "FLOOR" else "FLOOR", operand, unit)
            self.expect(")")
            return a.FunctionCall("CEIL" if up != "FLOOR" else "FLOOR", [operand])
        if up in ("TIMESTAMPADD", "TIMESTAMPDIFF", "DATEDIFF") and self.peek(1).value == "(":
            # first argument is a bare datetime-unit keyword
            self.next()
            self.expect("(")
            unit_tok = self.next()
            unit = unit_tok.value if unit_tok.type == TokenType.STRING else unit_tok.upper
            self.expect(",")
            args = [a.Literal(unit), self.parse_expr()]
            self.expect(",")
            args.append(self.parse_expr())
            self.expect(")")
            return a.FunctionCall(up, args)
        if up == "EXISTS" and self.peek(1).value == "(":
            self.next()
            self.expect("(")
            sub = self.parse_query()
            self.expect(")")
            return a.Exists(sub)
        if self.peek(1).value == "(":
            return self._parse_function_call()
        return self._parse_identifier_chain()

    def _parse_identifier_chain(self) -> a.Expr:
        parts = [self.parse_identifier()]
        quoted = [self.tokens[self.pos - 1].type == TokenType.QUOTED_IDENT]
        while self.accept("."):
            if self.peek().value == "*":
                self.next()
                return a.Wildcard(qualifier=parts)
            parts.append(self.parse_identifier())
            quoted.append(self.tokens[self.pos - 1].type == TokenType.QUOTED_IDENT)
        return a.Identifier(parts, quoted)

    def _parse_case(self) -> a.Expr:
        self.expect_keyword("CASE")
        operand = None
        if not self.at_keyword("WHEN"):
            operand = self.parse_expr()
        whens = []
        while self.accept_keyword("WHEN"):
            cond = self.parse_expr()
            self.expect_keyword("THEN")
            result = self.parse_expr()
            whens.append((cond, result))
        else_ = None
        if self.accept_keyword("ELSE"):
            else_ = self.parse_expr()
        self.expect_keyword("END")
        return a.Case(operand, whens, else_)

    def _parse_function_call(self) -> a.Expr:
        name = self.parse_identifier()
        self.expect("(")
        distinct = False
        args: List[a.Expr] = []
        if not self.accept(")"):
            if self.accept_keyword("DISTINCT"):
                distinct = True
            else:
                self.accept_keyword("ALL")
            if self.peek().value == "*":
                self.next()
                args.append(a.Wildcard())
            else:
                args.append(self.parse_expr())
            while self.accept(","):
                args.append(self.parse_expr())
            self.expect(")")
        ignore_nulls = False
        if self.accept_keyword("IGNORE"):
            self.expect_keyword("NULLS")
            ignore_nulls = True
        elif self.accept_keyword("RESPECT"):
            self.expect_keyword("NULLS")
        if self.at_keyword("WITHIN"):
            # PERCENTILE_CONT(q) WITHIN GROUP (ORDER BY x) — rewrite to (x, q)
            self.next()
            self.expect_keyword("GROUP")
            self.expect("(")
            self.expect_keyword("ORDER")
            self.expect_keyword("BY")
            order_expr = self.parse_expr()
            desc = False
            if self.accept_keyword("DESC"):
                desc = True
            else:
                self.accept_keyword("ASC")
            self.expect(")")
            if args and isinstance(args[0], a.Literal) and isinstance(args[0].value, (int, float)):
                q = args[0].value
                if desc:
                    q = 1.0 - float(q)
                args = [order_expr, a.Literal(float(q))]
            else:
                raise ParsingException(
                    "WITHIN GROUP requires a numeric literal fraction, e.g. "
                    "PERCENTILE_CONT(0.5) WITHIN GROUP (ORDER BY x)")
        filter_expr = None
        if self.at_keyword("FILTER") and self.peek(1).value == "(":
            self.next()
            self.expect("(")
            self.expect_keyword("WHERE")
            filter_expr = self.parse_expr()
            self.expect(")")
        over = None
        if self.accept_keyword("OVER"):
            if self.peek().value == "(":
                over = self._parse_window_spec()
            else:
                over = self.parse_identifier()  # named window, resolved in binder
        return a.FunctionCall(name.upper(), args, distinct, filter_expr, over, ignore_nulls)

    def _parse_window_spec(self) -> a.WindowSpec:
        self.expect("(")
        spec = a.WindowSpec()
        if self.accept_keyword("PARTITION"):
            self.expect_keyword("BY")
            spec.partition_by.append(self.parse_expr())
            while self.accept(","):
                spec.partition_by.append(self.parse_expr())
        if self.accept_keyword("ORDER"):
            self.expect_keyword("BY")
            spec.order_by = self.parse_order_items()
        if self.at_keyword("ROWS", "RANGE"):
            units = self.next().upper
            if self.accept_keyword("BETWEEN"):
                start = self._parse_frame_bound()
                self.expect_keyword("AND")
                end = self._parse_frame_bound()
            else:
                start = self._parse_frame_bound()
                end = ("CURRENT_ROW", None)
            spec.frame = a.WindowFrame(units, start, end)
        self.expect(")")
        return spec

    def _parse_frame_bound(self) -> Tuple[str, Optional[a.Expr]]:
        if self.accept_keyword("UNBOUNDED"):
            if self.accept_keyword("PRECEDING"):
                return ("UNBOUNDED_PRECEDING", None)
            self.expect_keyword("FOLLOWING")
            return ("UNBOUNDED_FOLLOWING", None)
        if self.accept_keyword("CURRENT"):
            self.expect_keyword("ROW")
            return ("CURRENT_ROW", None)
        offset = self.parse_expr()
        if self.accept_keyword("PRECEDING"):
            return ("PRECEDING", offset)
        self.expect_keyword("FOLLOWING")
        return ("FOLLOWING", offset)


def _parse_number(text: str):
    try:
        if "." not in text and "e" not in text and "E" not in text:
            return int(text)
        return float(text)
    except ValueError:
        raise ParsingException(f"Bad number literal {text!r}")


def parse_sql(sql: str) -> List[a.Statement]:
    """Parse one or more ;-separated statements (reference DaskParser::parse_sql).

    Queries go through the native (C++) parser when the library is built
    (native/parser.cpp emits a flat AST buffer that decodes to the same
    sqlast objects); DDL/ML statements and any native miss fall back to the
    Python parser.  DSQL_NATIVE_PARSER=0 disables the native path.
    """
    import os

    if os.environ.get("DSQL_NATIVE_PARSER", "1") != "0":
        try:
            from .native_bridge import native_parse

            stmts = native_parse(sql)
            if stmts is not None:
                return stmts
        except ParsingException:
            raise
        except Exception:  # noqa: BLE001 - any native issue -> Python path
            logger.debug("native parse failed; using Python parser",
                         exc_info=True)
    return Parser(sql).parse_statements()
