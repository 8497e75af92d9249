"""Model zoo (counterpart of ``paddle_tpu/models``): the GPT decode
lane's programs and GPT training, BERT pretraining, the image models
(ResNet, SE-ResNeXt, MobileNet, VGG, DenseNet, GoogLeNet and the MNIST
nets of ``mlp``) and Transformer NMT (``transformer``: training and
greedy decode)."""

from . import (bert, densenet, googlenet, gpt, mlp,  # noqa: F401
               mobilenet, resnet, se_resnext, transformer, vgg)
from .transformer import (TransformerConfig,  # noqa: F401
                          build_greedy_decode, build_transformer_nmt,
                          make_fake_batch)
