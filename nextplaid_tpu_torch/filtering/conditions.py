"""SQL-injection-safe WHERE-condition validation.

Reimplements the behavior of the reference's condition validator
(next-plaid src/filtering.rs:107-616): a quick safety scan, a
tokenizer, and a recursive-descent parser that only admits an allowlisted
grammar over schema-validated column names and `?` placeholders.

Allowed grammar::

    condition    = expr
    expr         = and_expr (OR and_expr)*
    and_expr     = unary_expr (AND unary_expr)*
    unary_expr   = NOT? primary_expr
    primary_expr = comparison | null_check | between_expr | in_expr | "(" expr ")"
    comparison   = identifier (comp_op | LIKE | REGEXP) placeholder
    null_check   = identifier IS NOT? NULL
    between_expr = identifier NOT? BETWEEN placeholder AND placeholder
    in_expr      = identifier NOT? IN "(" placeholder ("," placeholder)* ")"

String literals, numbers (except the `1=1` idiom), function calls, subqueries,
comments and semicolons are all rejected.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Sequence, Set, Tuple

from nextplaid_tpu_torch.utils.errors import FilteringError

_COLUMN_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_NUMERIC_EQ_RE = re.compile(r"^(\d+)\s*=\s*(\d+)$")

_DANGEROUS_KEYWORDS = (
    "SELECT", "UNION", "INSERT", "UPDATE", "DELETE", "DROP", "CREATE",
    "ALTER", "TRUNCATE", "EXEC", "EXECUTE", "GRANT", "REVOKE",
)

# Token kinds. Operators carry their kind only; identifiers carry the name.
_KEYWORDS = {
    "AND": "AND", "OR": "OR", "NOT": "NOT", "IS": "IS", "NULL": "NULL",
    "LIKE": "LIKE", "REGEXP": "REGEXP", "BETWEEN": "BETWEEN", "IN": "IN",
}
_COMPARISONS = {"=", "!=", "<>", "<", "<=", ">", ">="}


def is_valid_column_name(name: str) -> bool:
    """Identifier-shaped column names only (filtering.rs:97-105)."""
    return bool(_COLUMN_NAME_RE.match(name))


def quick_safety_check(condition: str) -> None:
    """Reject comments, semicolons and DDL/DML keywords (filtering.rs:146-181)."""
    if "--" in condition or "/*" in condition or "*/" in condition:
        raise FilteringError("SQL comments are not allowed in conditions")
    if ";" in condition:
        raise FilteringError("Semicolons are not allowed in conditions")
    upper = condition.upper()
    for kw in _DANGEROUS_KEYWORDS:
        if re.search(rf"\b{kw}\b", upper):
            raise FilteringError(f"SQL keyword '{kw}' is not allowed in conditions")


def tokenize(condition: str) -> List[Tuple[str, str]]:
    """Tokenize into (kind, text) pairs; raises on any unexpected character."""
    tokens: List[Tuple[str, str]] = []
    i, n = 0, len(condition)
    while i < n:
        c = condition[i]
        if c.isspace():
            i += 1
            continue
        if c == "?":
            tokens.append(("PLACEHOLDER", "?"))
            i += 1
            continue
        if c in "(),":
            tokens.append(({"(": "LPAREN", ")": "RPAREN", ",": "COMMA"}[c], c))
            i += 1
            continue
        two = condition[i : i + 2]
        if two in ("!=", "<>", "<=", ">="):
            tokens.append(("CMP", "<>" if two == "!=" else two))
            i += 2
            continue
        if c in "=<>":
            tokens.append(("CMP", c))
            i += 1
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (condition[j].isalnum() or condition[j] == "_"):
                j += 1
            word = condition[i:j]
            kind = _KEYWORDS.get(word.upper())
            tokens.append((kind, word) if kind else ("IDENT", word))
            i = j
            continue
        if c == '"':
            j = condition.find('"', i + 1)
            if j < 0:
                raise FilteringError("Unterminated quoted identifier")
            tokens.append(("IDENT", condition[i + 1 : j]))
            i = j + 1
            continue
        raise FilteringError(f"Unexpected character '{c}' in condition")
    tokens.append(("EOF", ""))
    return tokens


class _Parser:
    def __init__(self, tokens: Sequence[Tuple[str, str]], valid_columns: Set[str]):
        self.tokens = tokens
        self.pos = 0
        self.valid_lower = {c.lower() for c in valid_columns}
        self.columns_used: List[str] = []

    def peek(self) -> str:
        return self.tokens[self.pos][0]

    def advance(self) -> Tuple[str, str]:
        tok = self.tokens[self.pos]
        if self.pos < len(self.tokens) - 1:
            self.pos += 1
        return tok

    def expect(self, kind: str) -> None:
        if self.peek() != kind:
            raise FilteringError(
                f"Expected {kind}, found {self.tokens[self.pos][0]}"
            )
        self.advance()

    def parse(self) -> None:
        self.expr()
        if self.peek() != "EOF":
            raise FilteringError(
                f"Unexpected token {self.tokens[self.pos][1]!r} after expression"
            )

    def expr(self) -> None:
        self.and_expr()
        while self.peek() == "OR":
            self.advance()
            self.and_expr()

    def and_expr(self) -> None:
        self.unary()
        while self.peek() == "AND":
            self.advance()
            self.unary()

    def unary(self) -> None:
        if self.peek() == "NOT":
            self.advance()
        self.primary()

    def primary(self) -> None:
        if self.peek() == "LPAREN":
            self.advance()
            self.expr()
            self.expect("RPAREN")
            return
        kind, name = self.tokens[self.pos]
        if kind != "IDENT":
            raise FilteringError(f"Expected column name, found {name!r}")
        if name.lower() not in self.valid_lower:
            raise FilteringError(f"Unknown column '{name}' in condition")
        self.columns_used.append(name)
        self.advance()

        k = self.peek()
        if k == "IS":
            self.advance()
            if self.peek() == "NOT":
                self.advance()
            self.expect("NULL")
        elif k == "NOT":
            self.advance()
            k2 = self.peek()
            if k2 == "BETWEEN":
                self.advance()
                self.expect("PLACEHOLDER")
                self.expect("AND")
                self.expect("PLACEHOLDER")
            elif k2 == "IN":
                self.advance()
                self._in_list()
            elif k2 in ("LIKE", "REGEXP"):
                self.advance()
                self.expect("PLACEHOLDER")
            else:
                raise FilteringError(
                    f"Expected BETWEEN, IN, LIKE, or REGEXP after NOT, found {k2}"
                )
        elif k == "BETWEEN":
            self.advance()
            self.expect("PLACEHOLDER")
            self.expect("AND")
            self.expect("PLACEHOLDER")
        elif k == "IN":
            self.advance()
            self._in_list()
        elif k in ("LIKE", "REGEXP"):
            self.advance()
            self.expect("PLACEHOLDER")
        elif k == "CMP":
            self.advance()
            self.expect("PLACEHOLDER")
        else:
            raise FilteringError(
                f"Expected operator after column name, found {self.tokens[self.pos][1]!r}"
            )

    def _in_list(self) -> None:
        self.expect("LPAREN")
        self.expect("PLACEHOLDER")
        while self.peek() == "COMMA":
            self.advance()
            self.expect("PLACEHOLDER")
        self.expect("RPAREN")


def validate_condition(condition: str, valid_columns: Iterable[str]) -> List[str]:
    """Validate a WHERE condition; returns the column names it references.

    `1=1`-style numeric equalities are admitted as the conventional
    always-true/false idioms (filtering.rs:586-613).
    """
    if _NUMERIC_EQ_RE.match(condition.strip()):
        return []
    quick_safety_check(condition)
    parser = _Parser(tokenize(condition), set(valid_columns))
    parser.parse()
    return parser.columns_used
