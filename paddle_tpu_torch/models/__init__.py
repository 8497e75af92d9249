"""Model zoo (counterpart of ``paddle_tpu/models``).  Ported so far: the
GPT decode lane's programs and BERT pretraining."""
