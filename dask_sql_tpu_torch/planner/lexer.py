"""SQL lexer.

Copied from `dask_sql_tpu/planner/lexer.py`; only import paths and the
note on the native tokenizer differ.

Role parity: the tokenizer underneath the reference's Rust `DaskParser`
(src/parser.rs wraps sqlparser-rs's tokenizer).  Hand-written here; a C++
tokenizer with the same token stream contract lives in `native/`; the port
builds it into its `_build/` directory and uses it through
`planner/native_bridge.py`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..resilience.errors import ParseError


class TokenType:
    IDENT = "IDENT"
    QUOTED_IDENT = "QUOTED_IDENT"
    NUMBER = "NUMBER"
    STRING = "STRING"
    OP = "OP"
    PUNCT = "PUNCT"
    EOF = "EOF"
    PARAM = "PARAM"


@dataclass
class Token:
    type: str
    value: str
    pos: int

    @property
    def upper(self) -> str:
        return self.value.upper()

    def __repr__(self):
        return f"Token({self.type},{self.value!r})"


class LexError(ParseError):
    """Tokenizer rejection; shares ParseError's taxonomy slot (PARSE_ERROR,
    USER_ERROR) and remains a ValueError through it."""


_TWO_CHAR_OPS = {"<=", ">=", "<>", "!=", "||", "::", "->"}
_ONE_CHAR_OPS = set("+-*/%<>=~")
_PUNCT = set("(),.;[]{}:?")


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c.isspace():
            i += 1
            continue
        if c == "-" and i + 1 < n and sql[i + 1] == "-":  # line comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":  # block comment
            j = sql.find("*/", i + 2)
            if j < 0:
                raise LexError(f"Unterminated comment at {i}")
            i = j + 2
            continue
        if c == "'":  # string literal, '' escape
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError(f"Unterminated string at {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token(TokenType.STRING, "".join(buf), i))
            i = j + 1
            continue
        if c == '"' or c == "`":  # quoted identifier
            quote = c
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise LexError(f"Unterminated quoted identifier at {i}")
                if sql[j] == quote:
                    if j + 1 < n and sql[j + 1] == quote:
                        buf.append(quote)
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token(TokenType.QUOTED_IDENT, "".join(buf), i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_exp = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_exp and j + 1 < n and (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                    seen_exp = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            tokens.append(Token(TokenType.NUMBER, sql[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] in "_$"):
                j += 1
            tokens.append(Token(TokenType.IDENT, sql[i:j], i))
            i = j
            continue
        if sql[i : i + 2] in _TWO_CHAR_OPS:
            tokens.append(Token(TokenType.OP, sql[i : i + 2], i))
            i += 2
            continue
        if c in _ONE_CHAR_OPS:
            tokens.append(Token(TokenType.OP, c, i))
            i += 1
            continue
        if c == "?":
            tokens.append(Token(TokenType.PARAM, "?", i))
            i += 1
            continue
        if c in _PUNCT:
            tokens.append(Token(TokenType.PUNCT, c, i))
            i += 1
            continue
        raise LexError(f"Unexpected character {c!r} at position {i}")
    tokens.append(Token(TokenType.EOF, "", n))
    return tokens
