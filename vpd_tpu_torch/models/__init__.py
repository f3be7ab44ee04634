from .efficientnet import EfficientNet, build_effnet  # noqa
from .fc import FCNet, FCPoseDecoder, FCResNet, FCResNetPoseDecoder  # noqa
from .resnet import ResNet, ENCODER_ARCH, build_encoder  # noqa
