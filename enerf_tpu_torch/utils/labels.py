"""Segmentation label tables and their two lookups; counterpart of
``enerf_tpu/utils/labels.py`` (reference lib/utils/mask_utils.py).

The ADE20K table is the 150-class SceneParsing benchmark list, one ordered
tuple; the id <-> label dicts derive from it. The reference's spellings
are kept verbatim (the trailing space of ``'bed '`` included), so class
ids match any mask assets made for the reference.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

ADE20K_LABELS = (
    'wall', 'building', 'sky', 'floor', 'tree', 'ceiling', 'road', 'bed ',
    'windowpane', 'grass', 'cabinet', 'sidewalk', 'person', 'earth',
    'door', 'table', 'mountain', 'plant', 'curtain', 'chair', 'car',
    'water', 'painting', 'sofa', 'shelf', 'house', 'sea', 'mirror', 'rug',
    'field', 'armchair', 'seat', 'fence', 'desk', 'rock', 'wardrobe',
    'lamp', 'bathtub', 'railing', 'cushion', 'base', 'box', 'column',
    'signboard', 'chest of drawers', 'counter', 'sand', 'sink',
    'skyscraper', 'fireplace', 'refrigerator', 'grandstand', 'path',
    'stairs', 'runway', 'case', 'pool table', 'pillow', 'screen door',
    'stairway', 'river', 'bridge', 'bookcase', 'blind', 'coffee table',
    'toilet', 'flower', 'book', 'hill', 'bench', 'countertop', 'stove',
    'palm', 'kitchen island', 'computer', 'swivel chair', 'boat', 'bar',
    'arcade machine', 'hovel', 'bus', 'towel', 'light', 'truck', 'tower',
    'chandelier', 'awning', 'streetlight', 'booth', 'television receiver',
    'airplane', 'dirt track', 'apparel', 'pole', 'land', 'bannister',
    'escalator', 'ottoman', 'bottle', 'buffet', 'poster', 'stage', 'van',
    'ship', 'fountain', 'conveyer belt', 'canopy', 'washer', 'plaything',
    'swimming pool', 'stool', 'barrel', 'basket', 'waterfall', 'tent',
    'bag', 'minibike', 'cradle', 'oven', 'ball', 'food', 'step', 'tank',
    'trade name', 'microwave', 'pot', 'animal', 'bicycle', 'lake',
    'dishwasher', 'screen', 'blanket', 'sculpture', 'hood', 'sconce',
    'vase', 'traffic light', 'tray', 'ashcan', 'fan', 'pier',
    'crt screen', 'plate', 'monitor', 'bulletin board', 'shower',
    'radiator', 'glass', 'clock', 'flag',
)

HUMAN_LABELS = ('non_person', 'person')

id_label_mapping_ade20k: Dict[int, str] = dict(enumerate(ADE20K_LABELS))
label_id_mapping_ade20k: Dict[str, int] = {
    l: i for i, l in enumerate(ADE20K_LABELS)}
id_label_mapping_human: Dict[int, str] = dict(enumerate(HUMAN_LABELS))
label_id_mapping_human: Dict[str, int] = {
    l: i for i, l in enumerate(HUMAN_LABELS)}


def get_label_id_mapping(use_human_mask: bool = False) -> Dict[str, int]:
    return (label_id_mapping_human if use_human_mask
            else label_id_mapping_ade20k)


def get_class_ids_from_labels(labels: Sequence[str],
                              use_human_mask: bool = False) -> List[int]:
    mapping = get_label_id_mapping(use_human_mask)
    return [mapping[l] for l in labels]
