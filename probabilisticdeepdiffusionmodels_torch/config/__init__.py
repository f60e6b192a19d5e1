from .loader import CONFIG_DIR, deep_set, load_config, to_dict
