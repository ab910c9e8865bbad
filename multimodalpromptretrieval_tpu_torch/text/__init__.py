"""Host-side tokenizers.

Tokenization is I/O, not device compute (SURVEY.md §2b): token ids are
produced on the host and shipped to the device. Two tokenizers mirror the
reference's dependencies:

  * ``T5SentencePieceTokenizer`` — unigram-LM Viterbi encoder that loads a
    real ``spiece.model`` protobuf (what HF T5Tokenizer wraps via the C++
    sentencepiece lib) and reproduces T5's conventions (▁ whitespace
    escaping, dummy prefix, EOS append, extra_ids, added tokens).
  * ``CLIPBPETokenizer``       — OpenAI CLIP's byte-pair tokenizer
    (bytes_to_unicode + merges + </w> word suffix, SOT/EOT framing, 77-token
    context) loading the standard ``bpe_simple_vocab_16e6.txt(.gz)``.

Both also expose from_corpus()/toy constructors so tests and the synthetic
end-to-end pipeline run hermetically with no downloaded assets.
"""

from multimodalpromptretrieval_tpu_torch.text.spm import (  # noqa: F401
    T5SentencePieceTokenizer,
    UnigramVocab,
)
from multimodalpromptretrieval_tpu_torch.text.clip_bpe import CLIPBPETokenizer  # noqa: F401
