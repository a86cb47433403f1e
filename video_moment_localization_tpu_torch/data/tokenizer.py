"""Query tokenization.

Semantics match the reference tokenizer (reference utils.py:6-7):
lowercase -> strip all ASCII punctuation -> whitespace split.
"""

import string

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def get_tokens(query) -> list:
    """Tokenize a natural-language query string."""
    return str(query).lower().translate(_PUNCT_TABLE).strip().split()
