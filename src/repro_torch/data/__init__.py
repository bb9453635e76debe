from repro_torch.data.synthetic import (LanguageSpec, bigram_logits, eval_scores,
                                        modality_extras, sample_batch, scores_from_tokens,
                                        style_logits, style_permutation, train_batch)

__all__ = ["LanguageSpec", "bigram_logits", "eval_scores", "modality_extras",
           "sample_batch", "scores_from_tokens", "style_logits", "style_permutation",
           "train_batch"]
