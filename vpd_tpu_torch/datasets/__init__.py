"""Recognition datasets: dense embedding matrices, splits and loaders.

Counterparts of `vpd_tpu/datasets/*` (copies: this package imports
nothing of `vpd_tpu`). The data files themselves (labels, few-shot split
lists, the cached video metadata) are read in place from the JAX
package's tree, `vpd_tpu/datasets/data/`: reading a file is not an
import, and one copy of the data serves both packages.
"""

import os

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.realpath(__file__)))), 'vpd_tpu', 'datasets', 'data')
