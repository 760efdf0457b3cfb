"""The paper's own CNN configurations (Table 2, cases 1-7), as in
``repro/configs/bpt_cnn.py``."""
from repro_torch.models.cnn import TABLE2_CASES, CNNConfig, make_case

__all__ = ["TABLE2_CASES", "get_case", "DEFAULT"]


def get_case(case: str = "case2", image_size: int = 32,
             num_classes: int = 10) -> CNNConfig:
    return make_case(case, image_size=image_size, num_classes=num_classes)


DEFAULT = get_case("case2")
