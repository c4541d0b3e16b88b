"""paddle.vision for the port (counterpart of `paddle_tpu/vision`): the
model zoo, transforms, datasets, image IO and the detection ops."""
from . import datasets, image, models, ops, transforms  # noqa: F401
from .image import (get_image_backend, image_load,  # noqa: F401
                    set_image_backend)
from .models import (AlexNet, DenseNet, GoogLeNet,  # noqa: F401
                     InceptionV3, LeNet, MobileNetV1, MobileNetV2,
                     MobileNetV3, ResNet, ShuffleNetV2, SqueezeNet, VGG,
                     alexnet, densenet121, densenet161, densenet169,
                     densenet201, googlenet, inception_v3, mobilenet_v1,
                     mobilenet_v2, mobilenet_v3_large, mobilenet_v3_small,
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d, resnext50_64x4d, resnext101_32x4d,
                     resnext101_64x4d, resnext152_32x4d, resnext152_64x4d,
                     shufflenet_v2_x0_25, shufflenet_v2_x0_5,
                     shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                     shufflenet_v2_x2_0, squeezenet1_0, squeezenet1_1,
                     vgg16, wide_resnet50_2, wide_resnet101_2)
