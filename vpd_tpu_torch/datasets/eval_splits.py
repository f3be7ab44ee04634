"""Held-out test video prefixes (parity: `action_dataset/eval.py:4-43`).

Copied from `vpd_tpu/datasets/eval_splits.py` (this package
imports nothing of `vpd_tpu`).
"""

# Figure skating holds out every 2018 short program: both genders at
# both events (the names follow one pattern, so derive them).
FS_TEST_PREFIXES = tuple(
    '{}_{}_short_program_2018'.format(gender, event)
    for gender in ('men', 'women') for event in ('olympic', 'world'))

# Tennis holds out four whole matches by video name.
TENNIS_TEST_PREFIXES = ('usopen_2015_mens_final_federer_djokovic',
                        'usopen_2019_womens_osaka_gauff',
                        'wimbledon_2019_mens_semifinal_federer_nadal',
                        'wimbledon_2019_womens_final_halep_williams')


# tennis videos come in whole-court plus per-player camera variants;
# a held-out match excludes all three
_TENNIS_VIEWS = ('', 'front__', 'back__')


def _get_tennis_prefixes(video_list):
    return tuple(view + video for view in _TENNIS_VIEWS
                 for video in video_list)


_PREFIX_FAMILIES = (
    ('fs', lambda: FS_TEST_PREFIXES),
    ('tennis', lambda: _get_tennis_prefixes(TENNIS_TEST_PREFIXES)),
)


def get_test_prefixes(dataset):
    for family, prefixes in _PREFIX_FAMILIES:
        if dataset.startswith(family):
            return prefixes()
    raise NotImplementedError('Unknown dataset: {}'.format(dataset))
