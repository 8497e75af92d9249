"""Model zoo (counterpart of ``paddle_tpu/models``): the GPT decode
lane's programs and GPT training, BERT pretraining, and the image
models (ResNet, SE-ResNeXt, MobileNet, VGG, DenseNet, GoogLeNet and the
MNIST nets of ``mlp``)."""

from . import (bert, densenet, googlenet, gpt, mlp,  # noqa: F401
               mobilenet, resnet, se_resnext, vgg)
