"""paddle_tpu_torch.dataset — dataset reader creators (counterpart of the JAX
package's ``dataset/``; reference python/paddle/dataset/).

The reference downloads real corpora (mnist.py, cifar.py, uci_housing.py…).
Here, as in the JAX package, each module synthesizes (no download) a
deterministic, *learnable* dataset with the same sample shapes, dtypes, and
reader-creator API — models exercise the identical code paths (embedding
lookups, sequence batching, label shapes) and actually converge on the
synthetic distributions, which is what the book tests assert.
"""

from . import (cifar, common, conll05, flowers, image, imdb, imikolov, mnist,
               movielens, mq2007, sentiment, uci_housing, voc2012, wmt14,
               wmt16)

__all__ = ["mnist", "cifar", "uci_housing", "imikolov", "movielens", "wmt14",
           "wmt16", "conll05", "imdb", "flowers", "sentiment", "voc2012",
           "common", "image", "mq2007"]
