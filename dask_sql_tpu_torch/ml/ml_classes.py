"""Model class name resolution (parity: reference physical/utils/ml_classes.py
short-name -> FQCN maps for sklearn/cuML/XGBoost/LightGBM).  The engine's
own names resolve to ml/torch_models.py; sklearn FQCNs import directly.

Copied from `dask_sql_tpu/ml/ml_classes.py`, with `TPU_CLASSES` naming the
port's models: the SQL option ``backend`` keeps the reference's values,
and its default ``'tpu'`` means the engine's own family, so the same
statements run on both engines."""
from __future__ import annotations

import importlib
from typing import Any

TPU_CLASSES = {
    "LinearRegression": "dask_sql_tpu_torch.ml.torch_models.LinearRegression",
    "LogisticRegression": "dask_sql_tpu_torch.ml.torch_models.LogisticRegression",
    "KMeans": "dask_sql_tpu_torch.ml.torch_models.KMeans",
}

SKLEARN_CLASSES = {
    "LinearRegression": "sklearn.linear_model.LinearRegression",
    "LogisticRegression": "sklearn.linear_model.LogisticRegression",
    "SGDClassifier": "sklearn.linear_model.SGDClassifier",
    "SGDRegressor": "sklearn.linear_model.SGDRegressor",
    "KMeans": "sklearn.cluster.KMeans",
    "RandomForestClassifier": "sklearn.ensemble.RandomForestClassifier",
    "RandomForestRegressor": "sklearn.ensemble.RandomForestRegressor",
    "GradientBoostingClassifier": "sklearn.ensemble.GradientBoostingClassifier",
    "GradientBoostingRegressor": "sklearn.ensemble.GradientBoostingRegressor",
    "DecisionTreeClassifier": "sklearn.tree.DecisionTreeClassifier",
    "GaussianNB": "sklearn.naive_bayes.GaussianNB",
    "StandardScaler": "sklearn.preprocessing.StandardScaler",
    "XGBClassifier": "xgboost.XGBClassifier",
    "XGBRegressor": "xgboost.XGBRegressor",
    "LGBMClassifier": "lightgbm.LGBMClassifier",
    "LGBMRegressor": "lightgbm.LGBMRegressor",
}


def get_model_class(name: str, backend: str = "tpu") -> Any:
    """Resolve a model_class string: FQCN, short TPU-native name, or sklearn
    short name (parity: create_model.py class resolution CPU/GPU)."""
    if "." not in name:
        if backend == "tpu" and name in TPU_CLASSES:
            name = TPU_CLASSES[name]
        elif name in SKLEARN_CLASSES:
            name = SKLEARN_CLASSES[name]
        else:
            raise ValueError(f"Unknown model class {name!r}")
    module_name, _, class_name = name.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, class_name)
