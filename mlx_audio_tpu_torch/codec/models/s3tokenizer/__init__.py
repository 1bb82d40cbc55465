from .s3tokenizer import (S3_HOP, S3_SR, S3_TOKEN_HOP, S3_TOKEN_RATE, S3_V1_VOCAB_SIZE,
                          SPEECH_VOCAB_SIZE, ModelConfig, S3Tokenizer, S3TokenizerV2,
                          S3TokenizerV3, log_mel_spectrogram, make_non_pad_mask,
                          merge_tokenized_segments, padding)

__all__ = ["S3_HOP", "S3_SR", "S3_TOKEN_HOP", "S3_TOKEN_RATE", "S3_V1_VOCAB_SIZE",
           "SPEECH_VOCAB_SIZE", "ModelConfig", "S3Tokenizer", "S3TokenizerV2", "S3TokenizerV3",
           "log_mel_spectrogram", "make_non_pad_mask", "merge_tokenized_segments", "padding"]
