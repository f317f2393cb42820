"""DenseNet121 [CNN]: the second CNN of the paper's totals (Figs. 5-6).

224x224: 7x7/2 stem (+3x3/2 max-pool), dense blocks of (6, 12, 24, 16)
layers at growth 32 (each layer a 1x1 bottleneck to 4*growth then a 3x3
to growth, concatenated), with 1x1 channel-halving + 2x2 avg-pool
transitions between blocks. 120 convs.
"""
from repro_torch.configs.base import CNNConfig, ConvSpec, DenseStage


def config(sparse: bool = True) -> CNNConfig:
    from repro_torch.configs import cnn_sparsity_or_none

    return CNNConfig(
        name="densenet121",
        kind="densenet",
        stem=ConvSpec("conv1", 3, 64, 7, 7, 2, target="stem"),
        stages=(
            DenseStage(layers=6, growth=32),
            DenseStage(layers=12, growth=32),
            DenseStage(layers=24, growth=32),
            DenseStage(layers=16, growth=32),
        ),
        input_hw=224,
        num_classes=1000,
        sparsity=cnn_sparsity_or_none(sparse),
    )


def reduced(sparse: bool = True) -> CNNConfig:
    """CPU-sized: 32x32 input, 2 short dense blocks, growth 8."""
    from repro_torch.configs import cnn_sparsity_or_none

    return CNNConfig(
        name="densenet121-reduced",
        kind="densenet",
        stem=ConvSpec("conv1", 3, 8, 3, 3, 1, target="stem"),
        stages=(DenseStage(layers=2, growth=8), DenseStage(layers=2, growth=8)),
        input_hw=32,
        num_classes=10,
        sparsity=cnn_sparsity_or_none(sparse),
    )
