"""paddle_tpu_torch.nn — the port of `paddle_tpu/nn`: `Layer` and its
containers, `functional`, the initializers, `ParamAttr`, the layers
(common, conv, norm, pooling, activation, loss), `utils`, gradient
clipping (`clip`), the Transformer layers and the dense and paged
KV-cache helpers (`transformer`), the recurrent layers and their
sequence ops (`rnn`), beam search and the sampling filters of generation
(`decode`), and the fused paged-attention dispatch
(`paged_attention`)."""
from . import functional
from . import initializer
from .layer import (Layer, LayerList, Sequential, ParameterList,
                    HookRemoveHelper)
from .param_attr import ParamAttr
from .layers_common import (PairwiseDistance, Unfold,
                            Linear, Embedding, Dropout, Dropout2D, Dropout3D,
                            AlphaDropout, Flatten, Identity, Pad1D, Pad2D,
                            Pad3D, Upsample, UpsamplingBilinear2D,
                            UpsamplingNearest2D, PixelShuffle, Bilinear,
                            CosineSimilarity)
from .conv import (Conv1D, Conv2D, Conv3D, Conv2DTranspose,
                   Conv1DTranspose, Conv3DTranspose)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   SyncBatchNorm, LayerNorm, GroupNorm, InstanceNorm1D,
                   InstanceNorm2D, InstanceNorm3D, LocalResponseNorm,
                   SpectralNorm)
from .pooling import (MaxPool1D, MaxPool2D, MaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, AdaptiveAvgPool1D,
                      AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D,
                      AdaptiveMaxPool3D)
from .activation import (ReLU, ReLU6, Sigmoid, Tanh, Silu, Swish, Mish,
                         Hardswish, Hardsigmoid, Softsign, Tanhshrink, GELU,
                         LeakyReLU, ELU, CELU, SELU, PReLU, Hardtanh,
                         Hardshrink, Softshrink, Softplus, Softmax, LogSoftmax,
                         Maxout, LogSigmoid, ThresholdedReLU)
from .loss import (CTCLoss,
                   CrossEntropyLoss, MSELoss, L1Loss, SmoothL1Loss, NLLLoss,
                   BCELoss, BCEWithLogitsLoss, KLDivLoss, MarginRankingLoss,
                   HingeEmbeddingLoss, HSigmoidLoss)
from . import clip, decode, paged_attention, transformer
from .transformer import (MultiHeadAttention, TransformerEncoderLayer,
                          TransformerEncoder, TransformerDecoderLayer,
                          TransformerDecoder, Transformer)
from . import rnn
from .rnn import (RNNCellBase, SimpleRNNCell, LSTMCell, GRUCell, RNN, BiRNN,
                  SimpleRNN, LSTM, GRU, RNNBase)
from .decode import (BeamSearchDecoder, dynamic_decode,
                     top_k_top_p_filtering, sampling_id, greedy_search)
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue)
from . import utils
