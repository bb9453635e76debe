from repro_torch.data.synthetic import (LanguageSpec, bigram_logits, sample_batch,
                                        style_logits, style_permutation)

__all__ = ["LanguageSpec", "bigram_logits", "sample_batch", "style_logits",
           "style_permutation"]
