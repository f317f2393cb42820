"""ResNet50 [CNN]: the paper's primary per-layer workload (Fig. 4).

Bottleneck v1 structure at 224x224: 7x7/2 stem (+3x3/2 max-pool), then
stages of (1x1 mid, 3x3 mid, 1x1 out) blocks with projection shortcuts;
downsampling on the first block of stages 3-5, on the leading 1x1 and
the projection (every conv of a stage runs at the stage's output
resolution, as in the paper's per-layer GEMM table). 53 convs.
"""
from repro_torch.configs.base import BottleneckStage, CNNConfig, ConvSpec


def _stages() -> tuple[BottleneckStage, ...]:
    return (
        BottleneckStage(mid=64, out=256, blocks=3, stride=1),
        BottleneckStage(mid=128, out=512, blocks=4, stride=2),
        BottleneckStage(mid=256, out=1024, blocks=6, stride=2),
        BottleneckStage(mid=512, out=2048, blocks=3, stride=2),
    )


def config(sparse: bool = True) -> CNNConfig:
    from repro_torch.configs import cnn_sparsity_or_none

    return CNNConfig(
        name="resnet50",
        kind="resnet",
        stem=ConvSpec("conv1", 3, 64, 7, 7, 2, target="stem"),
        stages=_stages(),
        input_hw=224,
        num_classes=1000,
        sparsity=cnn_sparsity_or_none(sparse),
    )


def reduced(sparse: bool = True) -> CNNConfig:
    """CPU-sized: 32x32 input, 2 short stages, same block topology."""
    from repro_torch.configs import cnn_sparsity_or_none

    return CNNConfig(
        name="resnet50-reduced",
        kind="resnet",
        stem=ConvSpec("conv1", 3, 8, 3, 3, 1, target="stem"),
        stages=(
            BottleneckStage(mid=8, out=16, blocks=2, stride=1),
            BottleneckStage(mid=16, out=32, blocks=2, stride=2),
        ),
        input_hw=32,
        num_classes=10,
        sparsity=cnn_sparsity_or_none(sparse),
    )
