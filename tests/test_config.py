"""Config-system tests: schema, derived values, regeneration behaviour."""

import os

import pytest

from ysmr_tpu.config import create_configs, default_config_dict, get_configs


def test_create_and_get_roundtrip(tmp_ini):
    settings = get_configs(tmp_ini)
    assert settings is not None
    # spot-check defaults and derived semantics (reference helper_file.py:586-843)
    assert settings['pixel per micrometre'] == pytest.approx(1.41888781)
    assert settings['frames per second'] == 30.0
    assert settings['frame height'] == 922
    assert settings['frame width'] == 1228
    assert settings['white bacteria on dark background'] is True
    assert settings['threshold offset for detection'] == 5
    assert settings['adaptive double threshold'] == 2.0
    # rod preset collapses into the generic ratio keys
    assert settings['average width/height ratio min.'] == pytest.approx(0.125)
    assert settings['average width/height ratio max.'] == pytest.approx(0.67)
    # percent conversions
    assert settings['maximal empty frames in %'] == pytest.approx(1.05)
    assert settings['percent quantiles excluded area'] == pytest.approx(0.10)
    assert settings['percent of screen edges to exclude'] == pytest.approx(0.05)
    assert settings['stop excluding motility outliers if total count above percent'] \
        == pytest.approx(0.05)
    # violin split list parsed to floats
    assert settings['split violin plots on'] == [0.0, 20.0, 40.0, 60.0, 80.0, 100.01]
    # gsff
    assert settings['number of LSFFs'] == 3
    assert settings['maximum horizon size'] == 30
    # [TPU SETTINGS] defaults
    assert settings['frame batch size'] >= 1
    assert settings['max detections per frame'] >= 1
    import cv2
    assert settings['color filter'] == cv2.COLOR_BGR2GRAY


def test_dict_passthrough():
    d = {'already': 'parsed'}
    assert get_configs(d) is d


def test_coccoid_preset(tmp_path):
    path = str(tmp_path / 'tracking.ini')
    create_configs(path, open_editor=False)
    text = open(path).read().replace('rod shaped bacteria = True',
                                     'rod shaped bacteria = False')
    open(path, 'w').write(text)
    settings = get_configs(path)
    assert settings['average width/height ratio min.'] == pytest.approx(0.8)
    assert settings['average width/height ratio max.'] == pytest.approx(1.0)


def test_broken_ini_regenerated(tmp_path):
    path = str(tmp_path / 'tracking.ini')
    with open(path, 'w') as f:
        f.write('[BASIC RECORDING SETTINGS]\npixel per micrometre = nonsense\n')
    settings = get_configs(path)
    assert settings is None
    # regenerated file must now parse
    assert os.path.isfile(path)
    assert get_configs(path) is not None


def test_reference_era_ini_without_tpu_section(tmp_path):
    """A tracking.ini written by the reference (no [TPU SETTINGS]) still
    parses."""
    import configparser
    parser = configparser.ConfigParser(allow_no_value=True)
    defaults = default_config_dict()
    for section, values in defaults.items():
        if section == 'TPU SETTINGS':
            continue
        parser[section] = {k: str(v) for k, v in values.items()}
    path = str(tmp_path / 'tracking.ini')
    with open(path, 'w') as f:
        parser.write(f)
    settings = get_configs(path)
    assert settings is not None
    assert settings['frame batch size'] == defaults['TPU SETTINGS']['frame batch size']


def test_gsff_max_horizon_none(tmp_path):
    path = str(tmp_path / 'tracking.ini')
    create_configs(path, open_editor=False)
    text = open(path).read().replace('maximum horizon size = 30',
                                     'maximum horizon size = fps')
    open(path, 'w').write(text)
    settings = get_configs(path)
    assert settings is not None
    assert settings['maximum horizon size'] is None


def test_assertion_failure_regenerates(tmp_path):
    path = str(tmp_path / 'tracking.ini')
    create_configs(path, open_editor=False)
    text = open(path).read().replace('number of lsffs = 3', 'number of lsffs = 1')
    open(path, 'w').write(text)
    assert get_configs(path) is None


def test_ini_with_retired_pallas_key_loads(tmp_path):
    """A tracking.ini written before the hand-written kernels were retired
    still carries 'use pallas kernels' in [TPU SETTINGS]: it must load, and
    the key is ignored."""
    path = str(tmp_path / 'tracking.ini')
    create_configs(path, open_editor=False)
    text = open(path).read().replace(
        '[TPU SETTINGS]\n', '[TPU SETTINGS]\nuse pallas kernels = True\n')
    assert 'use pallas kernels' in text
    open(path, 'w').write(text)
    settings = get_configs(path)
    assert settings is not None
    assert 'use pallas kernels' not in settings
    assert settings['run cc'] == 'auto'
