from packnet_sfm_tpu_torch.config.cfg_node import CfgNode
from packnet_sfm_tpu_torch.config.defaults import get_cfg_defaults
from packnet_sfm_tpu_torch.config.config import (
    parse_test_file, parse_train_config, parse_train_file, prepare_config)
