from multimodal_rare_disease.data.tokenizer import (  # noqa: F401
    BertWordPieceTokenizer,
    build_wordpiece_vocab,
    get_tokenizer,
)
