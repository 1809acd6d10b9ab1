from .tokenizer import SimpleTokenizer, load_tokenizer  # noqa: F401
from .passages import PassageStore, load_passages_jsonl  # noqa: F401
