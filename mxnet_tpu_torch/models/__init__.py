"""Model zoo of the port: symbol definitions of the reference's acceptance
workloads, as `mxnet_tpu/models` builds them (the same graphs and names,
so parameters and JSON carry across packages)."""
from .mlp import get_mlp
from .lenet import get_lenet
from .alexnet import get_alexnet
from .vgg import get_vgg
from .inception_bn import get_inception_bn
from .resnet import get_resnet
from .lstm import lstm_unroll, lstm_cell
from .rnn import rnn_unroll, rnn_cell
from .transformer import get_transformer_lm, transformer_block
from .googlenet import get_googlenet
from .inception_v3 import get_inception_v3
from .fcn_xs import get_fcn_xs

__all__ = ["get_alexnet", "get_fcn_xs", "get_googlenet", "get_inception_bn",
           "get_inception_v3", "get_lenet", "get_mlp", "get_resnet",
           "get_transformer_lm", "get_vgg", "lstm_cell", "lstm_unroll",
           "rnn_cell", "rnn_unroll", "transformer_block"]
